#!/usr/bin/env python3
"""Drive the PyTorch port's slices on one NVIDIA H100: dense-cache serving,
paged / quantised / low-rank KV-cache serving, the serving front (a Router
over engine replicas on the card) and PAMM-compressed training of
internlm2-1.8b, with rematerialisation, reversible blocks and
checkpoint/restart; then serving and PAMM training of the MoE model
granite-moe-3b-a800m, of the state-space model mamba2-370m, of the
hybrid recurrentgemma-9b (RG-LRU and local-attention blocks) and of the
vision model llama-3.2-vision-11b (gated cross-attention over image
embeddings, decoded through K6 non-causal); then the audio model
musicgen-medium (embeddings in, four codebook heads out), scored, decoded
over embeddings and PAMM-trained at full size, and the port's four
examples (``repro_torch.examples``) run on the card; then data x context
training of internlm2-1.8b on gloo ranks sharing the card (ZeRO-1, the
int8 error-feedback all-reduce, ring attention over K3-K5's offsets); the
data axis inside one process: one engine's page pools split per replica
(K7 / K8 through the sharded wrappers), MoE's blocked dispatch; and
tensor parallelism: internlm2-1.8b trained over the model axis (column-
and row-parallel products, K1-K5 at the per-rank head counts), with a
compressed row-parallel ffn.down, granite-moe's experts, mamba2-370m's
heads, recurrentgemma-9b's RG-LRU width, llama-3.2-vision-11b's
cross-attention heads, musicgen-medium's codebook columns and reversible
blocks over it, on gloo ranks sharing the card.

  python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, serves
internlm2-1.8b at full width through the continuous-batching engine,
trains it at full width and depth for a few steps, and prints what it
measured. Phases, in order; the first failure exits non-zero and no phase
is caught and ignored:

  1. device and build   nvidia-smi's name and power limit, torch/CUDA
                        versions, one nvcc per kernel source in parallel
  2. K3 vs plain        prefill flash attention: internlm2's prefill shape
                        in bf16 (the tensor-core route), a sliding window,
                        head dims 80 and 120, the (q_off, k_off) operand
                        of two ring chunk pairs (one whose late rows see
                        no key), one f32-route case, and the batched
                        prefill of train.serve_step's per-token loop
                        (B 8 x 1024) in bf16
  3. K6 vs plain        flash decode, bf16: 8 slots x 1089 (5 splits of
                        256 slots), a parked row, a ring cache, head dims
                        80 and 120; two launches bitwise equal, and each
                        row alone bitwise equal to the same row at B = 8
  4. serving            internlm2-1.8b (24 layers, d 2048, 16/8 heads,
                        vocab 92544), bf16, random weights from seed 0,
                        8 slots, 16 requests of ~1024 prompt tokens and 32
                        new tokens (12 greedy, 4 at temperature 0.8 /
                        top-k 40): every request finishes, logits stay
                        finite, a second run gives the same tokens, greedy
                        requests give the same tokens alone, the launch
                        counts show K3 and K6 carried the attention, and
                        decode tokens agree with a teacher-forced prefill;
                        then torch.profiler splits one prefill and one
                        decode block by kernel and gives the idle share
  5. numbers            throughput, latency, kernel times next to their
                        plain versions, SDPA and the data-sheet bound;
                        each kernel also timed with the card kept busy
                        before the call (its device-only time) and on the
                        host's clock (its wrapper's host time per call)
  6. K7, K8 vs plain    paged decode, bf16, at the serving shape (8 slots x
                        17 pages of 64): shuffled pages, a hole, a parked
                        row (finite only), a ring, Lq 5, head dims 80 and
                        120, svd coefficients (r 64) with the dh-128
                        scale, K7 and K8 at 18, 3 and 1 splits (a split
                        without a mapped page; two launches bitwise
                        equal), int8 and int4 pages at 1 and 4 scale
                        groups
  7. paged serving      the serving phase's requests through page pools of
                        64: fp (tokens against the dense run up to near
                        ties, every token of each greedy stream against a
                        teacher-forced forward, a second run,
                        launch counts K7 = 24 x decode steps, peak memory,
                        a profiler split of one decode block); then, at
                        full width cut to 8 of 24 layers (SERVE_REPS), fp,
                        int8, int4 and svd(r=1/2) at one byte budget of
                        four bf16 reservations (pages, admitted
                        concurrency, released
                        pages, throughput, first-step logits against fp
                        within the JAX bounds, K8 on int8/int4, a profiler
                        split of one int8 decode block); at full depth,
                        prefix sharing of a 768-token head (tokens equal unshared,
                        the sharing counters, K7 launches); speculative
                        verify at k = 4 (tokens equal sequential greedy up
                        to a near tie, every token of each stream against
                        a teacher-forced forward, every decode step a
                        verify call through K7 at Lq 5)
  8. serving front      at full width cut to 8 of 24 layers: the serving
                        phase's requests at 16 new tokens
                        through Routers over 1, 2 and 4 paged fp replicas
                        (8 slots and a fixed pool of 2176 tokens each):
                        aggregate concurrency 2 / 4 / 8, greedy tokens at 2
                        and 4 replicas equal to 1 replica's (or near ties
                        held to a teacher-forced forward), sampled ones
                        bitwise equal, K3 = 8 x 16 prefills and K7 = 8 x
                        the replicas' decode steps, plain 0; 2 replicas
                        behind a 1-slot prefill engine (tokens equal, no
                        replica prefills, the host hand-off timed); one
                        engine holding the 4-replica budget as the
                        yardstick; the reference's decode_tok_s beside the
                        wall aggregate; a profiler split of one router step
                        at 4 replicas; then train.serve_step's
                        greedy_decode against greedy_decode_per_token (8 x
                        1024 prompts, 32 steps, dense: tokens up to near
                        ties, launches, wall ms per decode step: median
                        and quartiles over 2 rounds, the order alternating)
  9. K1, K2, K4/K5      the training kernels against their plain versions
     vs plain           at the training shapes: K1 (8192 x 2048, k 16) in
                        bf16 (tensor cores) and f32 and at k = b/8; K2 at m
                        2048 and 1024 (its split rule) and at m 1024 at 3 and
                        17 forced splits, each case's two launches bitwise
                        equal; K3 (whose o and lse
                        feed the backward) and K4/K5 at (4, 2048, 16/8,
                        128) bf16 (the tensor-core routes), a window of
                        256, head dims 80, 120, two ring chunk pairs'
                        offsets (the backward given a merged lse), each
                        output row held to its own norm, two launches of
                        K4/K5 bitwise equal; and one f32-route case
  10. card vs CPU       one train step of internlm2-1.8b_smoke in f32 with
                        the same parameters and generator rows on the card
                        (kernels) and on the CPU (plain versions)
  11. training          internlm2-1.8b, full width and depth, f32 params /
                        bf16 compute, attn.qkv=pamm(r=1/512), AdamW, batch
                        4 x 2048 from SyntheticStream: one warm-up step and
                        3 measured ones (finite losses, per-step launch
                        counts K1 24, K2 72, K3 = K4 = K5 24 on the
                        tensor-core routes, f32 routes and plain 0), a
                        second run from the seed (same step-0 loss), the
                        peak memory against attn.qkv=none, and a
                        torch.profiler split of one step
  12. training memory   the training cell under remat='full', remat='pamm'
      modes             and reversible blocks: one warm-up step and 2
                        measured ones each (peak memory beside phase 11's
                        remat='none', ms per step, tokens/s, launches per
                        step: K1 48 / 24 / 48, K2 72, K3 48, K4 = K5 24 on
                        the tensor-core routes, f32 routes and plain 0;
                        the step-0 loss of 'full' and 'pamm' against
                        'none''s within 1e-6); 4 x 8192 tokens under
                        'pamm' and reversible (one warm-up, one measured
                        step; remat='none' does not fit and is not run);
                        reversible on internlm2-1.8b_smoke in f32, the
                        card against the CPU (phase 10's bounds) and
                        against reversible_ref on the card (1e-4), and
                        the bf16 drift of the two printed; run_supervised
                        over 6 steps of internlm2-1.8b_smoke (a checkpoint
                        every 2, a fault injected at step 3: 1 restart, 6
                        steps, losses equal to an uninterrupted run's
                        within 1e-3), the save and load timed
  13. training numbers  K1, K2 (m 2048 and 1024), K4, K5 (and K3 at the
                        training shape) next to their plain versions, the
                        SDPA backward and the bound, K1 and K2 beside their
                        first versions and targets and beside the nearest
                        single PyTorch call (torch.mm of the dots, an
                        index_add_ of prescaled rows; neither computes the
                        kernel's function); then K7 and K8 (int8, int4) at
                        the serving shape beside their plain versions, the
                        bound and,
                        for K7, SDPA over the keys laid out densely
  14. MoE kernels        the batched K1 / K2 (every expert of the moe.expert
                        site in one launch) at its shapes: E 40 x 2048
                        capacity rows x d 1536, k 4 (and one f32-route K1
                        case), K2 at m 512 at the rule's split count and at
                        1, 3 and 17 forced ones; one expert all zero and
                        half of another; two launches and each of experts
                        0-2 against a 2-D launch bitwise equal; then K3,
                        K4/K5, K6, K7 and K8 (int8, int4) at granite's 24 /
                        8 heads of 64 (G 3) at the serving and training
                        shapes
  15. MoE serving       granite-moe-3b-a800m at full width cut to 8 of its
                        32 layers (d 1536, 40 experts top-8), bf16, random
                        weights from seed 0, the serving phase's 16
                        requests: dense (K3, K6) and paged fp (K7) layouts,
                        launch counts K3 = 8 x prefills and K6 / K7 = 8 x
                        decode steps,
                        prefill bucketing off, finite logits, a second run
                        identical, paged against dense equal up to near
                        ties of the batched decode step's own logits (expert
                        capacity couples a step's slots, so no solo run is
                        a reference); at capacity factor 16 (nothing
                        dropped) every greedy token against a
                        teacher-forced forward; then int8 and int4 page
                        pools at capacity factor 16 (K8 = 8 x decode
                        steps, no other decode kernel; greedy streams
                        against the fp run parting only at a near tie
                        widened by the format's JAX logit bound, 0.25 + 2
                        x 0.15 / 1.5, and every greedy token against a
                        teacher-forced forward at that margin); a profiler
                        split of one prefill and one decode block
  16. MoE training      granite-moe-3b-a800m, full width and depth, f32
                        params / bf16 compute, attn.qkv=pamm(r=1/512);
                        moe.expert=pamm(r=1/512), remat='pamm', AdamW,
                        batch 4 x 2048: one warm-up and 3 measured steps
                        (finite losses; launches a step K1 32 + 32 batched,
                        K2 96 + 64 batched, K3 64, K4 = K5 32, f32 routes
                        and plain 0; the sites' telemetry; the step and
                        forward + backward peaks; a profiler split), a
                        second run from the seed, and forward + backward
                        at 8 of the 32 layers under remat='none' with and
                        without the moe.expert rule (the site's saving);
                        then granite-moe-3b-a800m_smoke in f32, card
                        against CPU, and reversible against the CPU and
                        reversible_ref (1e-4)
  17. MoE numbers       the batched K1 / K2 as kernel rows (plain version,
                        bound, launches on the MoE training path), and
                        K3-K8 at granite's shapes beside their plain
                        versions, SDPA and the bound
  18. ssm kernels       K1 at the ssm.in site's shape (8192 x 1024, k 16)
                        and K2 at its gradient's (b 8192, k 16, m 4384: 17
                        column tiles of 256 and a ragged one of 32, at the
                        rule's split count and at 3), bf16, against their
                        plain versions, two launches bitwise equal
  19. ssm serving       mamba2-370m at full width cut to 8 of 48 layers
                        (d 1024, d_inner 2048, 32 heads of 64, state 128),
                        bf16, random weights from
                        seed 0, the serving phase's 16 requests, dense then
                        paged (no page pool: the state stays a dense slot
                        cache): no attention kernel and no plain version
                        launched, every request finished, finite logits,
                        bucketing off, both layouts' tokens equal to a
                        warm-up run's, greedy requests 0 and 1 alone equal
                        to batched, every greedy token against a
                        teacher-forced forward within the near tie; a
                        profiler split of one prefill and one decode block
  20. ssm training      mamba2-370m, full width and depth, f32 params /
                        bf16 compute, ssm.in=pamm(r=1/512), remat='pamm'
                        ('none' does not hold 48 layers at 4 x 2048),
                        AdamW, batch 4 x 2048: one warm-up and 3 measured
                        steps (finite losses; launches a step K1 = K2 = 48,
                        K3-K8 and plain 0; telemetry; step and forward +
                        backward peaks; a profiler split), forward +
                        backward under remat='none' at 16 of the 48 layers
                        with and without the ssm.in rule (the site's
                        saving), a second run from the seed; then
                        mamba2-370m_smoke in f32, card against CPU
  21. ssm numbers       K1 and K2 at the ssm.in site's shapes as kernel rows
                        (plain version, bound, launches on the mamba2
                        training path)
  22. rec kernels       K3-K8 at recurrentgemma's heads (16 / 1 of 256):
                        K4/K5 bf16 at (4, 2048) window 2048 and (1, 1030)
                        window 256, two launches bitwise equal, one f32
                        case; K3 at a 2100-token prompt; K6 over 1089 slots
                        and a wrapped 2048-slot ring; K7 / K8 int8 at the
                        paged shape and a 2048 ring pool; K1 (8192, 4096,
                        k 16), K2 m 4096 and 256
  23. rec serving       recurrentgemma-9b at full width cut to 11 of 38
                        layers (3 latt; d 4096, lru_width 4096, window
                        2048, vocab 256000), bf16, seed 0: the serving
                        phase's 16 requests, dense then paged (one ring
                        pool): K3 = 3 x prefills, K6 / K7 = 3 x
                        decode steps, no plain version, a second run, solo
                        = batched, paged = dense up to near ties, every
                        greedy token against a teacher-forced forward; one
                        2100-token request at max_len 2176 (the ring holds
                        positions 52..2099 after prefill), dense and paged;
                        a profiler split of one prefill and decode block
  24. rec training      recurrentgemma-9b_smoke in f32, card against CPU,
                        residual and reversible; then recurrentgemma-9b at
                        full width cut to 5 layers, f32 params / bf16
                        compute, attn.qkv and rglru.in PAMM (r=1/512),
                        remat='none', AdamW, 4 x 2048: one warm-up and 3
                        measured steps (finite losses; K1 5, K2 7, K3 = K4
                        = K5 1 a step; peaks; the f32 gate products' and
                        the scan's time), the sites' saving at 3 layers, a
                        second run
  25. rec numbers       K3 / K4 / K5 at dh 256 (SDPA as library), K1 and
                        K2 at recurrentgemma's shapes as kernel rows; K3,
                        K6, K7 at its serving shapes, printed
  26. vision kernels    K6 non-causal at llama-vision's decode shape (8
                        slots x 1601 image slots: 7 splits of 256, the
                        last 65 wide; 32 / 8 heads of 128, q_pos 0) in
                        bf16, with a row parked at -1, and in f32: every
                        row within 1e-2 of its norm, two launches bitwise
                        equal, each row alone bitwise equal to it at B =
                        8; at the same heads (G 4) K3 at (1, 1024) bf16
                        and (1, 1000) f32, K3 and K4/K5 at (4, 2048) (two
                        launches bitwise equal), K6 causal over 8 x 1089,
                        K7 (a parked row; a hole at 1 split) and K8 int8
                        at 8 x 17 pages; K1 at the attn.cross_kv site's
                        (6404, 4096, k 13) and K2 at b 6404, m 1024
  27. vision serving    llama-3.2-vision-11b at full width cut to 1 of its
                        8 units ((attn x4, xattn), 5 layers; d 4096,
                        32 / 8 heads of 128, vocab 128256,
                        1601 image tokens), bf16, seed 0, every gate_attn
                        and gate_ffn filled with 0.5 (zero at init: the
                        block would be the identity); the serving phase's
                        16 requests, each with its own image embeddings
                        from the stream, dense then paged fp: K3 = 4 x
                        prefills, dense K6 = 5 x decode steps, paged K7 =
                        4 x and K6 = 1 x decode steps (every one
                        non-causal), no plain version; bucketing on, a
                        second run, solo = batched, paged = dense up to
                        near ties, every greedy token of both layouts
                        against a teacher-forced forward (the einsum sdpa
                        over the image keys); a profiler split of one
                        prefill and one decode block
  28. vision training   llama-3.2-vision-11b_smoke in f32 (gates filled),
                        card against CPU; then llama-3.2-vision-11b at
                        full width cut to one unit (5 layers), gates
                        filled, f32 params / bf16 compute, attn.qkv and
                        attn.cross_kv PAMM (r=1/512), remat='none',
                        AdamW, 4 x 2048 tokens with 4 x 1601 image
                        tokens: one warm-up and 3 measured steps (finite
                        losses; K1 6, K2 15, K3 = K4 = K5 4 a step, f32
                        routes and plain 0; telemetry; peaks; a profiler
                        split), forward + backward peaks exact, under
                        attn.qkv alone and under both rules (the
                        attn.cross_kv site's saving), the cross-attention
                        sdpa's time a step, a second run
  29. vision numbers    K6 non-causal over the 1601 image slots (SDPA
                        non-causal as library), K3 / K4 / K5 at the
                        training shape (SDPA as library), K1 / K2 at the
                        attn.cross_kv site's shapes as kernel rows; K3,
                        K6 causal and K7 at its serving shapes, printed
  30. audio kernels     at musicgen's 24 / 24 heads of 64 (MHA, G 1), bf16:
                        K3 and K4/K5 at (4, 2048) and K3 at (8, 1024), two
                        launches of each bitwise equal; K6 over 8 x 1089
                        slots (row 3 parked at -1), two launches and each
                        row alone bitwise equal; K1 at the attn.qkv site's
                        (8192, 1536, k 16), K2 at b 8192, m 1536 and m 2048
                        (a lm_head rule's codebook columns)
  31. audio decode      musicgen-medium (48 layers, d 1536, 24 / 24 heads of
                        64, no token table, a (1536, 4 x 2048) head), bf16,
                        random weights from seed 0: a prefill over 8 x 1024
                        stream embeddings, then 8 decode steps each fed the
                        next embedding; every step's logits (8, 1, 8192)
                        against the full forward's at the same position
                        within 5e-2 of the row's largest |logit|; launches
                        K3 = 48 x 1 prefill, K6 = 48 x 8 steps, nothing
                        else; a profiler split of a prefill and a step
  32. audio training    musicgen-medium_smoke in f32, card against CPU, under
                        attn.qkv PAMM and with lm_head PAMM added (K1 / K2
                        once a codebook); musicgen-medium at full width and
                        depth, f32 params / bf16 compute,
                        attn.qkv=pamm(r=1/512), remat='pamm', AdamW, 4 x
                        2048 embeddings with four-codebook labels: one
                        warm-up and 3 measured steps (finite losses;
                        launches a step K1 48, K2 144, K3 96, K4 = K5 48,
                        f32 routes and plain 0; telemetry; step and forward
                        + backward peaks; a profiler split), forward +
                        backward at 16 layers under remat='none' with and
                        without the rule (the site's saving a layer), a
                        second run from the seed
  33. examples          the examples' kernels against their plain versions
                        at the examples' shapes: llama-tiny (4 / 4 heads of
                        32) over 8 x 64 tokens in f32, one train step card
                        against CPU under quickstart's spec and
                        finetune_compare's r = 1/128 and 1/256 (launches
                        K1 4, K2 12, K3 = K4 = K5 4); at pretrain's bf16,
                        K3 + K4/K5 at (8, 64), K1 at (512, 128, k 1), K2 at
                        m 128; serve_batched's f32 K3 over a 32-token
                        prompt and K6 over 4 slots of 49 at 4 / 2 heads of
                        16. Then repro_torch.examples on the card through
                        main(), no --device: quickstart (losses finite and falling,
                        its activation report), serve_batched on
                        internlm2-1.8b_smoke, pretrain for 20 steps with a
                        checkpoint in a temporary directory and resumed to
                        24, finetune_compare at 20 / 10 steps; K1-K5 (K3,
                        K6 serving) launched, no plain version
  34. audio numbers     K3 / K4 / K5 at (4, 2048, 24/24, 64) and K6 over 8 x
                        1089 at those heads (SDPA as library), K1 / K2 at
                        the attn.qkv site's shapes as kernel rows; K3 at
                        (8, 1024) and K2 at m 2048, printed
  35. ring kernels      K3 and K4/K5 against their plain versions at the
                        ring's chunk shape (2, 1024, 16/8, 128), with the
                        zigzag offsets of four chunk pairs of cp 2 (a
                        diagonal, an adjacent pair across a seam, two past
                        pairs), no window and a window of 1536 that crosses
                        a seam (rows that see no key held to lse <=
                        NEG_INF/2), bf16 and f32
  36. mesh data         internlm2-1.8b at full width cut to 4 of 24 layers
                        (MESH_LAYERS), attn.qkv=pamm(r=1/512),
                        remat='pamm', bf16 compute,
                        two gloo ranks sharing cuda:0 (launch.ranks spawns
                        them; rank 0 first runs the single-process step
                        with blocks=2 while rank 1 warms up): data 2, global
                        4 x 2048, steps 1 and 2: losses within 2e-3 and the
                        parameters' change over the two steps within 0.05 of
                        its norm of the single-process step's, launches a
                        rank and step K1 4, K2 12, K3 8, K4 = K5 4, each
                        rank's moments exactly half the single process's
                        (ZeRO-1); then int8_ef for the two steps: losses
                        within half the uncompressed run's decrease,
                        residues finite and non-zero, and before step 2 the
                        rank's own gradient of one leaf recomputed: the
                        residue the step leaves is ef_quantize(g + e)'s
                        (error feedback), and the ranks' mean of what they
                        sent is the compressed all-reduce; per rank ms a
                        step ("ranks sharing one H100 over gloo"), peak,
                        bytes between card and host a step
  37. mesh context      the same ranks, context 2: global 2 x 4096, each
                        rank a zigzag slice of 2048, one step: the loss
                        within 2e-3 of the single-process step's, the
                        step-1 gradients (after the all-reduce) of the
                        leaves attn.qkv does not compress within 0.05 of
                        their norm of the single-process ones (the ring's
                        backward), launches a rank K3 40, K4 = K5 20 (5
                        live chunk pairs a layer, the forward twice under
                        'pamm') on both ranks, each rank's peak beside the
                        single process's, the ring's send / recv staged
                        through pinned host buffers
  38. mesh data x       four ranks, data 2 x context 2, full width cut to 4
      context           layers (the state bytes reckoned and printed
                        first), global 4 x 4096, one step: the loss and the
                        gradients against the single-process step as in
                        37, launches K3 40, K4 = K5 20
  39. ring numbers      K3 / K4 / K5 at a fully visible ring chunk pair
                        (offs (3072, 1024)) as kernel rows (SDPA without a
                        mask as library; launches: rank 0's in phase 37)

Run after phase 8 (on internlm2-1.8b) and after phase 17 (on granite):

  40. sharded kernels   the sharded wrappers of K7 / K8 (the pools split
                        into dp per-replica shards, shard-local ids) against
                        their plain versions at the sharded serving shape
                        (8 slots, 5 pages of 64 a slot, 16/8 heads of 128,
                        bf16): dp 2 and 4, Lq 5, int8 and int4 pages; two
                        launches bitwise equal, and equal to K7 / K8 on the
                        folded pool through the offset table
  41. sharded serving   one engine on an in-process data mesh, internlm2
                        at full width cut to 8 of 24 layers: 8 requests of
                        ~256 prompt and 32 new tokens, greedy, through a
                        pool of 28 pages of 64 split per replica (dp 2 fp,
                        dp 2 int8, dp 4 fp), each against one engine over
                        the same pool: tokens equal up to near ties, K7 /
                        K8 = 8 x decode steps (one launch a layer whatever
                        dp, and the wrapper's count equal), every replica
                        serving at dp 4, every allocator drained, decode
                        tok/s and p50 / p95, peak concurrency, pages free a
                        replica, the id offset's host time a step; then the
                        two wrappers as kernel rows beside K7 / K8 on the
                        unsharded pool at the same live pages
  42. MoE blocked       granite-moe-3b-a800m at the serving cut (8 layers,
                        full width) with moe_token_blocks 2: one training
                        step at 4 x 2048 under remat='pamm' and the MoE
                        rules (the downgrade warnings; K1 8, K2 24, batched
                        K1 / K2 0; a finite loss a second run repeats); a
                        paged engine decoding with blocks 2 at capacity
                        factor 16 against a teacher-forced blocked forward;
                        moe_ffn blocked on granite smoke, card against the
                        CPU in f32 (output and every gradient, 1e-5)

Run after phase 39 (the mesh phases), on internlm2-1.8b:

  43. tensor parallel   full width and depth, attn.qkv=pamm(r=1/512),
                        remat='pamm', bf16 compute, two gloo ranks sharing
                        cuda:0, model 2 (each rank 8/4 heads, 4096 of the
                        FFN width, half the vocabulary; rank 0 first runs
                        the single-process step while rank 1 warms up),
                        global 4 x 2048, a warm-up step (index 0, rate 0)
                        and steps 1 and 2: losses within 2e-3 of the
                        single-process step's, step 1's gradients of every
                        leaf (gathered over the model ranks; the model ranks
                        draw the single process's generator rows) and the
                        parameters' change over the steps within 0.05 of
                        their norms, launches a rank and step K1 24, K2 72,
                        K3 48, K4 = K5 24 on both ranks; per rank ms a step
                        ("ranks sharing one H100 over gloo"), peak beside
                        the single process's, parameter and moment bytes,
                        bytes between card and host a step
  44. data x model      four ranks, data 2 x model 2, full width cut to 4
                        layers, ZeRO-1, the same batch and checks (blocks=2
                        single-process step), and each rank's moments equal
                        to its model then data slices of the gathered whole
  45. tp numbers        K3 / K4 / K5 at the per-rank shape (4, 2048, 8/4,
                        128) and K1 at (8192, 2048, k 16), K2 at m 1024
                        (wq's columns) and 512 (wk / wv's) against their
                        plain versions, then as kernel rows (SDPA as
                        library; launches: rank 0's in phase 43's two
                        measured steps)
  46-48. row-parallel   K1's split route against its plain versions;
         and experts    internlm2 with ffn.down compressed (4 layers) and
                        granite-moe with its experts over 2 ranks (8 of
                        32 layers) against the single-process step; their
                        kernel rows
  49. ssm tensor        mamba2-370m at full width, 12 of 48 layers, under
      parallel          ssm.in=pamm(r=1/512), remat='pamm', model 2 (a
                        rank's 16 of 32 heads, B / C whole), the checks of
                        phase 43 (the parameters' change over the leaves
                        no site estimates; ssm.in's printed), every leaf a
                        rank holds equal to its cut of the whole (in_proj
                        2320 / 4384 of it); the same at full depth in f32
                        compute (in bf16 the ranks' roundings part the
                        48-layer gradients past 0.05); then data 2 x
                        model 2 at 4 layers with the moments' slices
                        checked
  50. rec tensor        one (rec, rec, latt) unit of recurrentgemma-9b at
      parallel          full width under attn.qkv / rglru.in pamm,
                        remat='none', model 2, the same checks; the width
                        all-gather's and the model all-reduces' bytes
  51. ssm / rec         K1 on ssm.in's and rglru.in's whole rows, K2 at a
      numbers           rank's m 2320 and 2048, K3 / K4 / K5 at a rank's
                        latt heads (4, 2048, 8/1, 256), window 2048,
                        against their plain versions, then as kernel rows
  52. vision tensor     llama-3.2-vision-11b at full width, one (attn x 4,
      parallel          xattn) unit, gates filled, attn.qkv / attn.cross_kv
                        pamm, remat='none', model 2 (a rank's 16 / 4 heads,
                        7168 of d_ff, half the vocabulary; the image rows
                        whole), phase 43's checks; the attn.cross_kv state
                        equal on both ranks and to one process's; launches
                        a rank and step K1 6, K2 15, K3 = K4 = K5 4
  53. audio tensor      musicgen-medium at full width, 12 of 48 layers,
      parallel          attn.qkv pamm, remat='pamm', model 2 (a rank's 12 /
                        12 heads, 1024 of each codebook's 2048 head
                        columns: four parts), phase 43's checks
  54. reversible        internlm2-1.8b at full width, 4 layers, reversible
      tensor parallel   blocks, f32 compute, model 2, against the
                        single-process reversible step; launches K1 8, K2
                        12, K3 8, K4 = K5 4 (the f32 routes); the peak a
                        rank beside the residual model-2 step's
  55. xattn / audio /   K3 / K4 / K5 at a vision rank's (4, 2048, 16/4,
      rev numbers       128) and a musicgen rank's (4, 2048, 12/12, 64), K1
                        on attn.cross_kv's whole image rows (6404, 4096, k
                        13) and K2 at a rank's m 512, against their plain
                        versions, then as kernel rows

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. It imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# recurrentgemma's training cell under remat='none' peaks at 77.7 of the
# card's 79.2 GiB; after the earlier phases, fixed-size allocator segments
# left 4 GiB reserved but unusable at its step. Segments that grow in place
# leave no such gaps (read before torch first allocates on the card)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# NVIDIA H100 SXM data sheet (dense, 700 W): the bound's denominators
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
ARCH = "internlm2-1.8b"
SLOTS, MAX_LEN, DECODE_BLOCK = 8, 1089, 8
# 32 new tokens a request: at 64 the whole script passed 1200 s on a slow
# host; the decode kernels' checks and rows stay MID_DECODE tokens into a
# generation, where they were timed at 64 new tokens
PROMPT_LEN, N_REQUESTS, GEN = 1024, 16, 32
MID_DECODE = 32
SAMPLED = {3, 7, 11, 15}          # uids served at temperature 0.8 / top-k 40
TOL_O = 2e-2                       # bf16 outputs: a few bf16 ulps at |o| <= 1
# times of the first versions of the kernels redesigned since (scalar K3,
# K4 and K5, one-block-per-slot K6, K7 and K8, one-block-per-column-tile K2,
# scalar bf16 K1), from PERF.md's kernel table (an H100 80GB HBM3 at 700 W,
# timed as time_ms does by default), printed beside the new ones with the
# redesign's targets (a fifth of K3's time, 0.125 ms for K7, 1.2 and 1.6 ms
# for K4 and K5, 0.10 ms for K6 and K8, 0.05 ms for K1 and K2 at m 2048,
# 0.04 ms for K2 at m 1024)
FIRST_MS = {"K3 serving": 0.6391, "K3 training": 5.1018, "K7": 0.6230, "K4": 5.8892,
            "K5": 6.7245, "K6": 0.4142, "K8 int8": 0.6889, "K8 int4": 0.6720, "K1": 0.2310,
            "K2 m2048": 0.2859, "K2 m1024": 0.2668}
TARGET_MS = {"K3 serving": 0.128, "K3 training": 1.02, "K7": 0.125, "K4": 1.2, "K5": 1.6,
             "K6": 0.10, "K8 int8": 0.10, "K8 int4": 0.10, "K1": 0.05, "K2 m2048": 0.05,
             "K2 m1024": 0.04}
TOL_LSE = 1e-3                     # f32 lse from the same bf16 inputs
K3_SOURCE = "src/repro_torch/csrc/flash_attention_fwd.cu"
K6_SOURCE = "src/repro_torch/csrc/flash_decode.cu"
K3_REPLACES = "src/repro/kernels/flash_attention.py:263"
K6_REPLACES = "src/repro/kernels/flash_decode.py:147"
K78_SOURCE = "src/repro_torch/csrc/flash_paged_decode.cu"
K7_REPLACES = "src/repro/kernels/flash_decode.py:293"
K8_REPLACES = "src/repro/kernels/flash_decode.py:490"
PAGE = 64                          # kv_page_size's default
POOL_TOKENS = 4 * 1152             # four requests' reservation (18 pages of 64) in bf16
SHARED_PREFIX = 768                # prefix-sharing phase: shared head, 256-token tails
SPEC_K = 4
# serving front: a fixed pool per decode replica, two requests' reservation
# of 17 pages of 64 (the JAX package's BENCH_serving_disagg.json setting),
# capacity scaled by adding replicas behind the Router
FRONT_POOL = 2 * 17 * PAGE
FRONT_REPLICAS = (1, 2, 4)
# new tokens: 64 would add more than ~90 s; 32 took ~28 s more than 16,
# cut to keep the whole script in its limit with phases 40-42
FRONT_GEN = 16
SERVE_STEP_ROWS, SERVE_STEP_STEPS = 8, 32
SERVE_STEP_ROUNDS = 2              # engine / loop turns, each order half the time
# first spliced decode step, compressed pool against fp paged: the JAX
# package's per-format bounds (tests/test_kvquant.py:364-367)
FORMAT_TOL = {"int8": 0.15, "int4": 1.5, "svd(r=1/2)": 8.0}
# a near tie of bf16 logits (O(10)) after a deep stack: the top-2 margin
# under which two bf16 paths may pick different tokens
TOL_NEAR = 0.25
K1_SOURCE = "src/repro_torch/csrc/pamm_compress.cu"
K2_SOURCE = "src/repro_torch/csrc/pamm_apply.cu"
K45_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
K1_REPLACES = "src/repro/kernels/pamm_compress.py:60"
K2_REPLACES = "src/repro/kernels/pamm_apply.py:50"
K4_REPLACES = "src/repro/kernels/flash_attention.py:325"
K5_REPLACES = "src/repro/kernels/flash_attention.py:325"
# the training slice: the paper's setting on internlm2-1.8b
TRAIN_SPEC = "attn.qkv=pamm(r=1/512)"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 3
TOL_K1 = 1e-5        # |cs| (in [0, 1]) and relative ||x||: f32 sums in another order
TOL_K1_MARGIN = 1e-4 # idx compared where the plain top-2 |csim| margin exceeds this
TOL_K2 = 1e-5        # of max |Btilde|: f32 sums in another order; bitwise across launches
TOL_K45 = 2e-2       # of each gradient's max |.|: bf16 outputs
# per row of dh, |a - ref| / (|ref| + 1e-2 max |ref row|), bf16 outputs: a
# bf16 rounding flip moves an element by at most 2^-7 of itself, so a row
# by at most 2^-7 = 7.8e-3 of its norm; a row that loses or gains one
# 64-key tile of its ~i live keys moves by the order of sqrt(64 / i) of
# its norm, 0.18 at i = 2000, which the max-|.| tolerances above let pass
TOL_ROW = 1e-2
# K4/K5's f32 route: f32 sums over up to L terms in another order, of each
# gradient's max |.| and per row (the card tests' f32 bounds)
TOL_K45_F32, TOL_ROW_F32 = 1e-4, 1e-3
# training memory modes: launches a step of K1, K2, K3, K4, K5 (bf16 routes)
MODE_LAUNCHES = {"none": (24, 72, 24, 24, 24), "full": (48, 72, 48, 24, 24),
                 "pamm": (24, 72, 48, 24, 24), "reversible": (48, 72, 48, 24, 24)}
MODE_RCFG = {"full": {"remat": "full"}, "pamm": {"remat": "pamm"},
             "reversible": {"block_structure": "reversible"}}
MODE_STEPS = 2
LONG_SEQ = 8192                    # the longer context: remat='none' does not fit
TOL_REV = 1e-4       # reversible vs reversible_ref, f32: max |diff| / max |ref| per leaf
TOL_RESTART = 1e-3   # restored vs uninterrupted losses: phase 11's second-run bound
TOL_CPU_LOSS = 1e-5  # card vs CPU in f32: relative loss
TOL_CPU_GRAD = 1e-3  # card vs CPU in f32: relative norm of each gradient's difference
ADAM_EPS = 1e-8      # optim.adamw_update's eps: a zero-initialised leaf's first step
# the MoE slice: granite-moe-3b-a800m (32 layers, d 1536, 24 / 8 heads of 64,
# 40 experts top-8, moe_d_ff 512), the paper's QKV rule plus the moe.expert
# site; at 4 x 2048 tokens an expert's capacity is 2048 rows, k = 2048 / 512
MOE_ARCH = "granite-moe-3b-a800m"
MOE_SPEC = "attn.qkv=pamm(r=1/512);moe.expert=pamm(r=1/512)"
MOE_E, MOE_CAP, MOE_D, MOE_F, MOE_K = 40, 2048, 1536, 512, 4
MOE_HEADS = (24, 8, 64)              # H, KV, dh: G 3
MOE_CUT_LAYERS = 8                   # the site's saving, measured under remat='none'
MOE_SMOKE, MOE_SMOKE_SPEC = ("granite-moe-3b-a800m_smoke",
                             "attn.qkv=pamm(r=1/8);moe.expert=pamm(r=1/4)")
# the ssm slice: mamba2-370m (48 layers, d 1024, d_inner 2048, 32 heads of 64,
# state 128, 1 group, conv 4, chunk 128): its in-projection is the ssm.in site,
# K1 at n 1024 and K2 at m = d_in_proj 4384 (17 column tiles of 256 and a
# ragged one of 32); k = 8192 / 512
SSM_ARCH = "mamba2-370m"
SSM_SPEC = "ssm.in=pamm(r=1/512)"
SSM_D, SSM_M, SSM_K = 1024, 4384, 16
SSM_SMOKE, SSM_SMOKE_SPEC = "mamba2-370m_smoke", "ssm.in=pamm(r=1/8)"
# remat='none' cannot hold 48 layers' activations at 4 x 2048 (about 1.45
# GiB a layer: out of memory on the 80 GB card), so the cell trains under
# 'pamm', and the site's saving is measured under 'none' at a cut depth
SSM_REMAT = "pamm"
SSM_CUT_LAYERS = 16
# the rec slice: recurrentgemma-9b (38 layers, (rec, rec, latt) x 12 + (rec,
# rec); d 4096, lru_width 4096, 16 / 1 heads of 256 (MQA, G 16),
# local_window 2048, d_ff 12288, vocab 256000). Its rglru.in site is a rec
# block's w_x: K1 at n 4096, K2 at m 4096; a latt block's attn.qkv: K1 at n
# 4096, K2 at m 4096 (wq) and 256 (wk, wv); k = 8192 / 512
REC_ARCH, REC_SMOKE = "recurrentgemma-9b", "recurrentgemma-9b_smoke"
REC_SPEC = "attn.qkv=pamm(r=1/512);rglru.in=pamm(r=1/512)"
REC_SMOKE_SPEC = "attn.qkv=pamm(r=1/8);rglru.in=pamm(r=1/8)"
REC_HEADS = (16, 1, 256)             # H, KV, dh: G 16
REC_WINDOW = 2048
REC_D, REC_K, REC_M = 4096, 16, (4096, 256)
# one request whose 2100-token prompt wraps the 2048-slot ring in prefill
REC_LONG_PROMPT, REC_LONG_MAX = 2100, 2176
# training at full width, cut to the smoke arch's stage layout (5 layers,
# 3.23 B parameters; all 38 would need about 156 GiB of f32 state). Its
# parameters, gradients and AdamW moments take 48 GiB, and with remat='none'
# its step still fits the card's 80 GB, so it trains under 'none'; the
# sites' saving is measured at REC_CUT_STAGES, where an exact run fits too
REC_TRAIN_STAGES = ((("rec", "rec", "latt"), 1), (("rec", "rec"), 1))
REC_CUT_STAGES = ((("rec", "rec", "latt"), 1),)
REC_REMAT = "none"
# the xattn slice: llama-3.2-vision-11b (40 layers, (attn x4, xattn) x 8; d
# 4096, 32 / 8 heads of 128, d_ff 14336, vocab 128256, 1601 image tokens).
# Its attn.qkv site is every layer's input (K1 at n 4096; K2 at m 4096 for
# wq, 1024 for wk and wv); its attn.cross_kv site the image embeddings
# (4 x 1601 = 6404 rows, k 13; K2 at m 1024). Both gates start at zero,
# which makes an xattn block the identity: every vision phase fills them
# with VIS_GATE first, so that cross-attention moves the logits
VIS_ARCH, VIS_SMOKE = "llama-3.2-vision-11b", "llama-3.2-vision-11b_smoke"
VIS_SPEC = "attn.qkv=pamm(r=1/512);attn.cross_kv=pamm(r=1/512)"
VIS_SMOKE_SPEC = "attn.qkv=pamm(r=1/8);attn.cross_kv=pamm(r=1/8)"
VIS_HEADS = (32, 8, 128)             # H, KV, dh: G 4
VIS_TOKENS, VIS_D = 1601, 4096
VIS_CROSS_B, VIS_CROSS_K, VIS_CROSS_M = 4 * 1601, 13, 1024
VIS_GATE = 0.5
# training at full width, cut to one unit (5 layers, 2.14 B parameters:
# about 32 GiB of f32 parameters, gradients and AdamW moments)
VIS_TRAIN_STAGES = ((("attn", "attn", "attn", "attn", "xattn"), 1),)
VIS_REMAT = "none"
# the audio slice: musicgen-medium (48 attn layers, d 1536, 24 / 24 heads of
# 64 (MHA, G 1), d_ff 6144; embed-input: no token table, a (d, 4 x 2048)
# head, four codebooks). Its attn.qkv site is every layer's input: K1 at n
# 1536, K2 at m 1536 (wq, wk, wv); a lm_head rule's K2 at m 2048 (one
# codebook's columns); k = 8192 / 512. Its 1.8 B parameters take 27 GiB of
# f32 state with AdamW, so it trains at full depth; 'none' would peak near
# 70-75 of the card's 79.2 GiB, so the cell trains under 'pamm' and the
# site's saving is measured under 'none' at a cut depth
AUDIO_ARCH, AUDIO_SMOKE = "musicgen-medium", "musicgen-medium_smoke"
AUDIO_SPEC = "attn.qkv=pamm(r=1/512)"
AUDIO_SMOKE_SPECS = ("attn.qkv=pamm(r=1/8)", "attn.qkv=pamm(r=1/8);lm_head=pamm(r=1/8)")
AUDIO_HEADS = (24, 24, 64)           # H, KV, dh: G 1
AUDIO_D, AUDIO_K, AUDIO_M = 1536, 16, (1536, 2048)
AUDIO_REMAT = "pamm"
AUDIO_CUT_LAYERS = 16
AUDIO_DECODE_STEPS = 8
# a decode step's bf16 logits against the full forward's at the same
# position, of the row's largest |logit|: the two paths round differently in
# each of 48 layers (K6 against K3, matrix products of other shapes). The
# plain versions on the CPU drift by 4.3e-3, 1.0e-2 and 1.7e-2 at 2, 8 and 24
# layers of musicgen's width (tools/audio_drift.py), about as the square
# root of the depth: some 2.3e-2 at 48, held here at about twice that
TOL_AUDIO_DECODE = 5e-2
# the examples: llama-tiny trained over 8 x 64 tokens (quickstart,
# pretrain, finetune_compare); serve_batched's arch, its 4 slots, its
# prompts of 23-32 tokens (one prefill bucket of 32) and its cache of
# 32 + 16 + 1 slots
EXAMPLE_ARCH, EXAMPLE_BATCH, EXAMPLE_SEQ = "llama-tiny", 8, 64
EXAMPLE_SERVE_ARCH = "internlm2-1.8b_smoke"
EXAMPLE_SLOTS, EXAMPLE_PROMPT, EXAMPLE_CACHE = 4, 32, 49
# the examples' launch names of each kernel, either route
EXAMPLE_KERNELS = {"K1": ("csim_argmax",), "K2": ("segment_matmul",),
                   "K3": ("flash_attention_fwd", "flash_attention_fwd_f32"),
                   "K4": ("flash_attention_dq", "flash_attention_dq_f32"),
                   "K5": ("flash_attention_dkv", "flash_attention_dkv_f32"),
                   "K6": ("flash_decode",)}
# the kernels of the other slices: none may launch on the ssm path
ATTN_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_f32", "flash_attention_dq",
                "flash_attention_dkv", "flash_attention_dq_f32", "flash_attention_dkv_f32",
                "flash_decode", "flash_paged_decode", "flash_paged_decode_quant")
# substrings of cuBLAS / CUTLASS matrix-product kernel names on Hopper
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")


# The later models' serving phases run at full width cut to these stage
# repeats (granite-moe 8 of 32 layers, mamba2 8 of 48, recurrentgemma 11
# of 38 with 3 latt, llama-vision 1 unit of 8), which keeps the script
# inside its time limit with the mesh phases and phases 40-42 (with mamba2
# and llama-vision served at full depth it took 1202 s on an H100 whose
# host was slow; mamba2 at 12 and llama-vision at 2 units until phases
# 40-42 came); their training phases keep their depths. internlm2-1.8b
# serves at full depth in phases 4-7's dense and paged fp runs, prefix
# sharing and speculative verify, and at 8 of 24 layers (its own seed-0
# weights) in the compressed pools, the serving front, serve_step and the
# sharded pools: with the tensor-parallel phases the script took 880 s
# on one host and passed 1200 s on a slower one
SERVE_REPS = {ARCH: (8,), MOE_ARCH: (8,), SSM_ARCH: (8,), REC_ARCH: (3, 1), VIS_ARCH: (1,)}


def serve_cfg(arch):
    """``arch`` at full width, each stage repeated ``SERVE_REPS[arch]``
    times."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    stages = tuple((unit, rep) for (unit, _), rep in zip(cfg.stages, SERVE_REPS[arch]))
    return dataclasses.replace(cfg, stages=stages,
                               n_layers=sum(len(unit) * rep for unit, rep in stages))


def fail(msg: str) -> None:
    print(f"chip_smoke FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def row_err(a, ref) -> float:
    """Largest error of a row (the last axis) relative to the reference
    row's norm, floored at 1e-2 of the largest reference row: rows near 0
    by cancellation (dq of the first query) are held to the floor."""
    a, ref = a.float(), ref.float()
    den = ref.norm(dim=-1)
    return ((a - ref).norm(dim=-1) / (den + 1e-2 * den.max()).clamp_min(1e-30)).max().item()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for the work on the card: the larger of bytes over
    the memory rate and operations over the bf16 peak."""
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")


def visible_pairs(L: int, *, causal: bool, window: int) -> int:
    """(query, key) pairs the causal / window mask leaves, per head."""
    pairs = 0
    for i in range(L):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else L
        pairs += max(0, hi - lo)
    return pairs


def k3_work(B, L, H, KV, dh, *, causal: bool, window: int, itemsize: int):
    """(flops, bytes) of one K3 call: 4*dh per visible (query, key) pair
    and head; q, k, v read once, o and lse written once."""
    pairs = visible_pairs(L, causal=causal, window=window)
    flops = 4.0 * dh * pairs * H * B
    nbytes = B * L * (2 * H + 2 * KV) * dh * itemsize + B * H * L * 4
    return flops, nbytes


def k6_work(q_pos, slot_pos, H, KV, dh, *, window: int, itemsize: int,
            causal: bool = True):
    """(flops, bytes) of one K6 call on this data: the K/V rows of the
    slots each query can see (read once), q, o, the positions. A
    non-causal call sees every live slot whatever its ``q_pos``."""
    qp = q_pos[:, None]
    live = slot_pos >= 0
    if causal:
        live &= slot_pos <= qp
    if window > 0:
        live &= qp - slot_pos < window
    n_live = int(live.sum())
    B, S = slot_pos.shape
    flops = 4.0 * dh * n_live * H
    nbytes = (2 * n_live * KV * dh * itemsize + 2 * B * H * dh * itemsize
              + (B * S + B) * 4)
    return flops, nbytes


def k1_work(b, n, k, itemsize):
    """(flops, bytes) of one K1 call: the b*k dots and the norms; x and c
    read once, cs / idx / norm written once."""
    return 2.0 * b * n * (k + 1) + 2.0 * k * n, (b + k) * n * itemsize + 12 * b


def k2_work(b, m, k, itemsize):
    """(flops, bytes) of one K2 call: a multiply-add per dZ element; dZ,
    f, alpha read once, Btilde (k, m) f32 written once."""
    return 2.0 * b * m, b * m * itemsize + 8 * b + 4 * k * m


def k45_work(B, L, H, KV, dh, *, causal: bool, window: int, itemsize: int, which: str):
    """(flops, bytes) of K4 (6*dh per visible pair and head: q k^T, dO v^T,
    ds k) or K5 (8*dh: q k^T, dO v^T, p^T dO, ds^T q); q, k, v, dO, lse,
    delta read once, dq (K4) or dk, dv (K5) written once."""
    pairs = visible_pairs(L, causal=causal, window=window)
    per_pair = 6.0 if which == "K4" else 8.0
    reads = B * L * (2 * H + 2 * KV) * dh * itemsize + 2 * B * H * L * 4
    writes = B * L * H * dh * itemsize if which == "K4" else 2 * B * L * KV * dh * itemsize
    return per_pair * dh * pairs * H * B, reads + writes


def time_ms(fn, reps: int = 25, warmup: int = 3, flush=None, pad: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, each after an
    L2 flush (the caller in the serving loop finds its inputs cold). The
    window opens when the flush ends, so a call whose wrapper spends more
    host time before its launch than the flush takes on the card carries
    the difference: the protocol every kernel row's ``ms`` uses. With
    ``pad`` a spin kernel keeps the card busy between the flush and the
    call, so only the card's own time is left (``device_ms``)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if pad:
            torch.cuda._sleep(1_000_000)           # ~0.5 ms of device time
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` (a kernel's wrapper: checks,
    allocation, the ctypes call and its launches), from the host's clock
    over ``calls`` calls issued back to back with no sync between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / calls


def timing_note(row, key):
    """The timing protocols side by side, and the redesign's target under
    the first (the one the first versions were timed with)."""
    met = "met" if row["ms"] <= TARGET_MS[key] else "MISSED"
    return (f" (first version {FIRST_MS[key]:.4f} ms; target {TARGET_MS[key]} ms: {met}) "
            f"| device only {row['device_ms']:.4f} ms | wrapper host "
            f"{1e3 * row['host_ms']:.1f} us/call")


def ring_slot_pos(B, S, n_tokens, device):
    """slot_pos of a ring of S slots after writing positions 0..n-1."""
    import torch

    j = torch.arange(S, device=device)
    last = n_tokens - 1 - ((n_tokens - 1 - j) % S)
    return torch.where(last >= 0, last, -1).to(torch.int32).expand(B, S).contiguous()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device_and_build():
    import torch

    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernels built/found in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for kernel, line in ptxas_lines(log.read_text() if log.exists() else ""):
            print(f"[build] {name}: {kernel}: {line}")
    return smi


def short_symbol(name: str) -> str:
    """A demangled kernel symbol without its return type, parameters and
    namespaces: ``split_kernel<Dense<__nv_bfloat16>, 128>``."""
    name = name.strip().replace("(anonymous namespace)::", "")
    depth, start, end = 0, 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch == " ":
            start = i + 1                       # past the return type
        elif depth == 0 and ch == "(":
            end = i                             # the parameter list
            break
    head = name[start:end]
    depth, cut = 0, 0
    for i, ch in enumerate(head):
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and head.startswith("::", i):
            cut = i + 2                         # past a namespace
    return head[cut:] or name


def ptxas_lines(log: str):
    """(kernel, line) for each registers / spill line of an nvcc -Xptxas -v
    log, the kernel's symbol shortened to its name and template arguments
    (demangled by c++filt where the toolkit has one)."""
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    kernel = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            if filt:
                kernel = short_symbol(subprocess.run([filt, kernel], capture_output=True,
                                                     text=True).stdout) or kernel
        elif "registers" in line or "spill" in line:
            yield kernel, line.split("ptxas info    :")[-1].strip()


def _randn(shape, gen, dtype=None):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype or torch.bfloat16)


def check_k3(q, k, v, *, window, offs=None, label=""):
    """One K3 call against its plain version: o and lse on the rows that
    see a key (max |.|, lse, worst row); a row that sees none (offsets at a
    window edge) must have lse <= NEG_INF / 2 and a finite o. Returns
    (max |o - o_ref|, o, lse)."""
    import torch

    from repro_torch.kernels.flash_attention import (NEG_INF, _iota_mask,
                                                     flash_attention_fwd_cuda,
                                                     flash_attention_fwd_ref)

    B, L, H, dh = q.shape
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=True, window=window, offs=offs)
    o_r, lse_r = flash_attention_fwd_ref(q, k, v, causal=True, window=window, offs=offs)
    seen = _iota_mask(L, True, window, q.device, offs).any(-1)
    e_o = (o[:, seen].float() - o_r[:, seen].float()).abs().max().item()
    e_l = (lse[..., seen] - lse_r[..., seen]).abs().max().item()
    e_r = row_err(o[:, seen], o_r[:, seen])
    n_dead = int((~seen).sum())
    route = "tensor cores" if q.dtype == torch.bfloat16 else "f32 route"
    print(f"[K3] B={B} L={L} H={H} KV={k.shape[2]} dh={dh} window={window} offs={offs} "
          f"{str(q.dtype)[6:]} ({route}{label}): max|o-o_ref|={e_o:.3e} (tol {TOL_O}) "
          f"max|lse-lse_ref|={e_l:.3e} (tol {TOL_LSE}) worst row rel {e_r:.3e} (tol "
          f"{TOL_ROW}); {n_dead} rows see no key" + (" (lse <= NEG_INF/2, o finite)"
                                                     if n_dead else ""))
    check(bool(o.isfinite().all()) and e_o <= TOL_O and e_l <= TOL_LSE and e_r <= TOL_ROW
          and bool((lse[..., ~seen] <= NEG_INF / 2).all()),
          f"K3 disagrees with its plain version at {(B, L, H, dh, window, offs, q.dtype)}")
    return e_o, o, lse


def phase_k3(gen):
    """K3 against its plain version at the serving shapes: both routes,
    windows, head dims 80 / 120, and the (q_off, k_off) operand of ring
    chunk pairs (fully visible; a window edge whose late rows see no key)."""
    import torch

    cases = [  # B, L, H, KV, dh, window, offs, dtype
        (1, 1024, 16, 8, 128, 0, None, torch.bfloat16),
        (1, 1024, 16, 8, 128, 256, None, torch.bfloat16),
        (1, 1000, 16, 8, 80, 0, None, torch.bfloat16),
        (1, 1000, 16, 8, 120, 0, None, torch.bfloat16),
        (1, 1024, 16, 8, 128, 0, (1024, 0), torch.bfloat16),
        (1, 1024, 16, 8, 128, 256, (2048, 1024), torch.bfloat16),
        (1, 1000, 16, 8, 128, 256, (2048, 1024), torch.float32),
        # greedy_decode_per_token's batched prefill (phase 8)
        (SERVE_STEP_ROWS, PROMPT_LEN, 16, 8, 128, 0, None, torch.bfloat16),
    ]
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for B, L, H, KV, dh, window, offs, dtype in cases:
        q = _randn((B, L, H, dh), gen, dtype)
        k = _randn((B, L, KV, dh), gen, dtype)
        v = _randn((B, L, KV, dh), gen, dtype)
        e, _, _ = check_k3(q, k, v, window=window, offs=offs)
        worst[dtype] = max(worst[dtype], e)
    return worst[torch.bfloat16]


def check_k6(gen, B, S, H, KV, dh, *, ring: bool, ring_slots: int = 256,
             n_ring: int = 600, step: int = 97, dtype=None) -> float:
    """K6 against its plain version at one decode shape (slot b filled to
    S - ``step`` b, row 3 parked; or a ring of ``ring_slots`` after
    ``n_ring`` tokens, window ``ring_slots``), bf16 unless ``dtype``: two
    launches and each row alone bitwise equal to the batch. Returns
    max |o - o_ref|."""
    import torch

    from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_ref

    fills = torch.tensor([S - step * b for b in range(B)], device="cuda")
    check(ring or int(fills.min()) > 0, f"K6 case: S {S} is too short for step {step}")
    Sx = ring_slots if ring else S
    window = ring_slots if ring else 0
    q = _randn((B, 1, H, dh), gen, dtype)
    k = _randn((B, Sx, KV, dh), gen, dtype)
    v = _randn((B, Sx, KV, dh), gen, dtype)
    if ring:
        n = n_ring
        spos = ring_slot_pos(B, Sx, n, "cuda")
        qpos = torch.full((B,), n - 1, dtype=torch.int32, device="cuda")
    else:
        j = torch.arange(Sx, device="cuda")
        spos = torch.where(j[None, :] < fills[:, None], j[None, :], -1).to(torch.int32)
        qpos = (fills - 1).to(torch.int32)
    qpos[3] = -1                                   # a parked slot
    o = flash_decode_cuda(q, k, v, qpos, spos, causal=True, window=window)
    again = flash_decode_cuda(q, k, v, qpos, spos, causal=True, window=window)
    check(torch.equal(o, again), f"K6: a second launch gave other bits (dh={dh} ring={ring})")
    # the split count is a function of S alone: a row alone = the row at B = 8
    alone = all(torch.equal(flash_decode_cuda(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                              qpos[b:b + 1], spos[b:b + 1], causal=True,
                                              window=window), o[b:b + 1])
                for b in range(B))
    check(alone, f"K6: a row decoded alone differs from it at B={B} (dh={dh} ring={ring})")
    o_r = flash_decode_ref(q, k, v, qpos, spos, causal=True, window=window)
    e = (o.float() - o_r.float()).abs().max().item()
    print(f"[K6] B={B} S={Sx} H={H} KV={KV} dh={dh} window={window} {str(q.dtype)[6:]} "
          f"(row 3 parked): max|o-o_ref|={e:.3e} (tol {TOL_O}); two launches bitwise "
          f"equal; each row alone bitwise equal to it at B={B}")
    check(bool(o.isfinite().all()), "K6 output of a parked row is not finite")
    check(e <= TOL_O, f"K6 disagrees with its plain version at dh={dh} ring={ring}")
    return e


def phase_k6(gen):
    return max(check_k6(gen, SLOTS, MAX_LEN, 16, 8, dh, ring=ring)
               for dh, ring in ((128, False), (128, True), (80, False), (120, False)))


def _requests(cfg, gen: int = GEN):
    from repro_torch.launch.serve import _build_requests
    from repro_torch.serve import SamplingParams

    args = argparse.Namespace(prompt_len=PROMPT_LEN, requests=N_REQUESTS, gen=gen,
                              temperature=0.0, top_k=0, seed=0)
    reqs = _build_requests(cfg, args)
    for r in reqs:
        if r.uid in SAMPLED:
            r.sampling = SamplingParams(temperature=0.8, top_k=40, seed=r.uid)
    return reqs


def phase_serving():
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import launches
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine

    cfg = get_config(ARCH)
    rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
    t0 = time.perf_counter()
    model = init_model(cfg, rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {ARCH}: {n_params / 1e9:.3f} B params (bf16) initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    engine = lambda: ServeEngine(cfg, rcfg, model, max_slots=SLOTS, max_len=MAX_LEN,
                                 decode_block=DECODE_BLOCK)

    warm = engine().run(_requests(cfg))               # warm-up (cuBLAS, allocator)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    eng = engine()
    out = eng.run(_requests(cfg))                      # the measured main path
    torch.cuda.synchronize()
    counts = launches.counts()
    stats = eng.stats()
    peak = torch.cuda.max_memory_allocated()

    check(sorted(out) == list(range(N_REQUESTS)), "not every request finished")
    check(all(len(out[u].tokens) == GEN for u in out), f"a request did not get {GEN} tokens")
    check(stats["nonfinite_logits"] == 0,
          f"{stats['nonfinite_logits']} non-finite logits rows")
    check(all(out[u].tokens == warm[u].tokens for u in out),
          "a second run gave different tokens")
    n_layers = cfg.n_layers
    print(f"[serve] launches {counts} | prefills {stats['prefill_count']} | "
          f"decode steps {stats['decode_steps']}")
    check(counts.get("flash_attention_fwd", 0) == n_layers * stats["prefill_count"]
          and counts.get("flash_attention_fwd_f32", 0) == 0,
          "K3's tensor-core route launches != 24 x prefills, or the f32 route ran")
    check(counts.get("flash_decode", 0) == n_layers * stats["decode_steps"],
          "K6 launches != 24 x decode steps")
    check(counts.get("flash_attention_fwd_ref", 0) == 0
          and counts.get("flash_decode_ref", 0) == 0,
          "a plain version ran on the main path")
    for uid in (0, 1):                                 # greedy, alone
        req = [r for r in _requests(cfg) if r.uid == uid]
        solo = engine().run(req)[uid]
        check(solo.tokens == out[uid].tokens,
              f"greedy request {uid} alone differs from its batched run")
    print(f"[serve] {N_REQUESTS}/{N_REQUESTS} requests x {GEN} tokens; second run identical; "
          f"greedy requests 0 and 1 identical alone and batched; logits finite")
    check_against_prefill(cfg, rcfg, model, _requests(cfg)[0], out[0].tokens)
    trace_breakdown(cfg, engine, model, {
        "prefill": 1e3 * stats["prefill_s"] / max(1, stats["prefill_count"]),
        "decode block": 1e3 * stats["decode_s"] / max(1, stats["decode_steps"]) * DECODE_BLOCK})
    dense = {"cfg": cfg, "rcfg": rcfg, "model": model,
             "tokens": {u: out[u].tokens for u in out}}
    return counts, stats, peak, dense


def cut_serving(dense) -> dict:
    """The serving phase's ``dense`` with internlm2-1.8b at full width cut
    to ``SERVE_REPS[ARCH]`` layers, initialised from seed 0 on the card,
    for the phases that serve it cut."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model

    cfg = serve_cfg(ARCH)
    model = init_model(cfg, dense["rcfg"], seed=0, device="cuda")
    print(f"[serve] {ARCH} cut to {cfg.n_layers} of {get_config(ARCH).n_layers} layers for the "
          f"compressed pools, the serving front, serve_step and the sharded pools")
    return {**dense, "cfg": cfg, "model": model}


def check_against_prefill(cfg, rcfg, model, req, tokens, every: int = 8):
    """The engine's greedy tokens (K3 prefill, then K6 decode steps) against
    the argmax of a fresh prefill over prompt + tokens[:t] (K3 only), as
    the JAX serving tests hold their engine to a teacher-forced forward.
    Where the argmax differs, the two bf16 paths must be at a near tie:
    the prefill's top-2 margin below 0.25 (logits are O(10); bf16 keeps
    ~3 significant digits through 24 layers)."""
    import torch

    from repro_torch.models import prefill

    worst, n_diff = 0.0, 0
    for t in range(0, len(tokens), every):
        seq = torch.tensor([list(req.tokens) + tokens[:t]], device="cuda")
        logits, _ = prefill(cfg, rcfg, model, {"tokens": seq}, seq.shape[1])
        row = logits[0, -1, : cfg.vocab_size]
        check(bool(torch.isfinite(row).all()), "non-finite prefill logits")
        if int(row.argmax()) != tokens[t]:
            top2 = row.topk(2).values
            margin = float(top2[0] - top2[1])
            n_diff, worst = n_diff + 1, max(worst, margin)
            check(margin < 0.25, f"decode token {t} disagrees with prefill argmax "
                                 f"at a margin of {margin:.3f}")
    print(f"[serve] request 0: decode tokens vs teacher-forced prefill argmax at "
          f"{len(range(0, len(tokens), every))} positions: {n_diff} near-tie "
          f"differences (largest top-2 margin {worst:.4f})")


def trace_breakdown(cfg, engine, model, unprofiled_ms: dict, tag: str = ""):
    """Device time by kernel group over one prefill and one decode block
    (torch.profiler), and the device's busy share of the same work's wall
    time in the measured main-path run (``unprofiled_ms``; the profiler's
    own host overhead inflates the wall time it sees)."""
    import torch

    eng = engine()
    reqs = _requests(cfg)[:SLOTS]
    for slot, req in enumerate(reqs[1:], start=1):
        eng.insert(eng.prefill(model, req), eng.decode_state, slot)
    torch.cuda.synchronize()
    for label, work in (("prefill", lambda: eng.insert(eng.prefill(model, reqs[0]),
                                                       eng.decode_state, 0)),
                        ("decode block", lambda: eng.generate(model, eng.decode_state))):
        if label not in unprofiled_ms:
            work()
            continue
        profile_split(label, work, unprofiled_ms[label], tag)


def profile_split(label, work, base_ms: float, tag: str = ""):
    """Device time by kernel group of one ``work()`` under torch.profiler,
    printed against ``base_ms``, the same work's unprofiled wall time.
    Returns the groups' device ms (empty if the profiler saw no device
    activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups: dict[str, float] = {}
    others: dict[str, float] = {}
    for evt in prof.key_averages():
        # device-side entries only: a CPU op (aten::mm) carries its
        # kernels' time too, and counting both would count it twice
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type != DeviceType.CUDA or us <= 0:
            continue
        name = evt.key
        # the decode kernels share one split body (decode_split::
        # split_kernel<source, width>) and one merge_kernel
        split = "split_kernel" in name
        group = ("K3" if "fwd_kernel" in name else "K6" if split and "Dense" in name
                 else "K7/K8" if split and ("Paged" in name or "Quant" in name)
                 else "merge" if "merge_kernel" in name
                 else "GEMM" if any(s in name.lower() for s in GEMM_NAMES)
                 else "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        if group == "other":
            others[name] = us / 1e3
    if "merge" in groups:    # a block runs one decode kernel: the merge is its second launch
        owner = "K6" if "K6" in groups else "K7/K8"
        groups[owner] = groups.get(owner, 0.0) + groups.pop("merge")
    busy = sum(groups.values())
    if busy == 0:
        print(f"[trace] {tag}{label}: device time not measured (the profiler recorded "
              f"no device activity); wall {wall_ms:.2f} ms")
        return groups
    parts = " | ".join(f"{g} {ms:.3f} ms" for g, ms in
                       sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"[trace] {tag}{label}: device busy {busy:.3f} ms of {base_ms:.2f} ms unprofiled "
          f"wall ({100 * busy / base_ms:.1f}% busy, {100 - 100 * busy / base_ms:.1f}% idle; "
          f"{wall_ms:.2f} ms under the profiler) | {parts}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:4]
    print(f"[trace] {tag}{label}: largest other kernels: "
          + " | ".join(f"{ms:.3f} ms {name[:60]}" for name, ms in top))
    return groups


def _kernel_row(name, source, replaces, launches, err, fn, plain, lib, work):
    """One entry of the JSON kernel line; ``lib`` None where no single
    PyTorch call computes the same function."""
    flush = _flush_buffer()
    ms = time_ms(fn, flush=flush)
    device_ms = time_ms(fn, flush=flush, pad=True)
    wrapper_ms = host_ms(fn)
    plain_ms = time_ms(plain, reps=20, flush=flush)
    lib_ms = None if lib is None else time_ms(lib, flush=flush)
    bms, by = bound(*work)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, "device_ms": device_ms,
            "host_ms": wrapper_ms}


def timed_line(model, tag, label, fn, plain, lib, work, launch_note):
    """Print a kernel's time at one of ``model``'s shapes beside its
    device-only time, its plain version, ``lib`` (one PyTorch call of the
    same function, or None) and the bound, as the kernel rows time them."""
    flush = _flush_buffer()
    ms, dev = time_ms(fn, flush=flush), time_ms(fn, flush=flush, pad=True)
    plain_ms = time_ms(plain, reps=10, flush=flush)
    lib_ms = "none" if lib is None else f"{time_ms(lib, flush=flush):.4f} ms"
    bms, by = bound(*work)
    print(f"[numbers] {model} {label}: {ms:.4f} ms/call | device only {dev:.4f} ms | plain "
          f"{plain_ms:.4f} ms | library {lib_ms} | bound {bms:.4f} ms ({by}) | "
          f"{launch_note} {tag}")


def site_k1_k2_rows(gen, b, n, k, k1_name, k2_names, launches, errs):
    """Kernel rows of K1 at a site's (b, n, k) and of K2 at (b, m, k) for
    each (m, name) of ``k2_names``, bf16, with the training path's
    ``launches`` and the kernel phase's ``errs``. Returns (the rows, K2's
    idx and scales, for lines at other widths)."""
    import torch

    from repro_torch.kernels.pamm_apply import segment_matmul_cuda, segment_matmul_ref
    from repro_torch.kernels.pamm_compress import csim_argmax_cuda, csim_argmax_ref

    x = _randn((b, n), gen)
    c = x[torch.randperm(b, generator=gen, device="cuda")[:k]].contiguous()
    f = torch.randint(0, k, (b,), generator=gen, device="cuda", dtype=torch.int32)
    alpha = torch.randn(b, generator=gen, device="cuda")
    rows = [_kernel_row(k1_name, K1_SOURCE, K1_REPLACES, launches.get("csim_argmax", 0),
                        errs["K1"], lambda: csim_argmax_cuda(x, c),
                        lambda: csim_argmax_ref(x, c), None, k1_work(b, n, k, 2))]
    del x, c
    for m, name in k2_names:
        gz = _randn((b, m), gen)
        rows.append(_kernel_row(name, K2_SOURCE, K2_REPLACES, launches.get("segment_matmul", 0),
                                errs["K2"], lambda: segment_matmul_cuda(f, alpha, gz, k),
                                lambda: segment_matmul_ref(f, alpha, gz, k), None,
                                k2_work(b, m, k, 2)))
        del gz
    return rows, (f, alpha)


def print_rows(rows, notes, tag):
    """Print kernel rows, each with its (launch note, shape note) of
    ``notes``."""
    for row, (note, at) in zip(rows, notes):
        print(f"[numbers] {row['name']}{at}: {row['ms']:.4f} ms/call | device only "
              f"{row['device_ms']:.4f} ms | wrapper host {1e3 * row['host_ms']:.1f} us/call | "
              f"plain {row['plain_ms']:.4f} ms | library "
              + ("n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms (SDPA)")
              + f" | bound {row['bound_ms']:.4f} ms ({row['bound_by']}) | {row['launches']} "
              f"{note} {tag}")


def attention_inputs(gen, B, L, H, KV, dh, window=0):
    """Random bf16 inputs of K3, K4 and K5 at (B, L, H / KV, dh), causal
    with ``window`` (0, or at least L: SDPA's causal mask then computes the
    same function). Returns {"K3" | "K4" | "K5": (kernel, plain, library,
    work)}: the library column is SDPA's forward, or its backward through
    the same inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (_delta, _launch_dkv, _launch_dq,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_fwd_cuda,
                                                     flash_attention_fwd_ref)

    check(window == 0 or window >= L, f"SDPA's causal mask is not window {window} at L {L}")
    q = _randn((B, L, H, dh), gen)
    kk, v = _randn((B, L, KV, dh), gen), _randn((B, L, KV, dh), gen)
    do = _randn((B, L, H, dh), gen)
    qt = q.transpose(1, 2).detach().requires_grad_()
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).detach().requires_grad_()
              for t in (kk, v))
    o, lse = flash_attention_fwd_cuda(q, kk, v, causal=True, window=window)
    delta = _delta(o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(kk), torch.empty_like(v)
    out = F.scaled_dot_product_attention(qt, kx, vx, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kx, vx), do.transpose(1, 2),
                                           retain_graph=True)
    plain_bwd = lambda: flash_attention_bwd_ref(q, kk, v, o, lse, do, causal=True,
                                                window=window)
    work = functools.partial(k45_work, B, L, H, KV, dh, causal=True, window=window, itemsize=2)
    return {
        "K3": (lambda: flash_attention_fwd_cuda(q, kk, v, causal=True, window=window),
               lambda: flash_attention_fwd_ref(q, kk, v, causal=True, window=window),
               lambda: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True),
               k3_work(B, L, H, KV, dh, causal=True, window=window, itemsize=2)),
        "K4": (lambda: _launch_dq(q, kk, v, lse, delta, do, dq, True, window), plain_bwd,
               sdpa_bwd, work(which="K4")),
        "K5": (lambda: _launch_dkv(q, kk, v, lse, delta, do, dk, dv, True, window), plain_bwd,
               sdpa_bwd, work(which="K5"))}


def k6_inputs(gen, H, KV, dh, q_at, window=0):
    """Random bf16 inputs of K6 over SLOTS dense slots of MAX_LEN, every
    row at q_pos ``q_at`` with slots 0..q_at filled, causal with ``window``
    (0, or wider than the cache: SDPA's slot mask then computes the same
    function). Returns (kernel, plain, library, work), as an entry of
    attention_inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_ref

    B, S = SLOTS, MAX_LEN
    q = _randn((B, 1, H, dh), gen)
    kc, vc = _randn((B, S, KV, dh), gen), _randn((B, S, KV, dh), gen)
    qpos = torch.full((B,), q_at, dtype=torch.int32, device="cuda")
    j = torch.arange(S, device="cuda", dtype=torch.int32)
    spos = torch.where(j[None, :] <= qpos[:, None], j[None, :], -1).to(torch.int32)
    mask = ((spos >= 0) & (spos <= qpos[:, None]))[:, None, None, :]
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (kc, vc))
    qt = q.transpose(1, 2)
    return (lambda: flash_decode_cuda(q, kc, vc, qpos, spos, causal=True, window=window),
            lambda: flash_decode_ref(q, kc, vc, qpos, spos, causal=True, window=window),
            lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask),
            k6_work(qpos, spos, H, KV, dh, window=window, itemsize=2))


def decode_lines(gen, line, H, KV, dh, window, serve):
    """Print K6 over SLOTS dense slots of MAX_LEN and K7 over 17 pages of
    PAGE a slot, mid-generation, at (H / KV, dh) and ``window`` (0, or
    wider than the cache), beside the launches of ``serve``'s dense and
    paged runs, through ``line`` (a timed_line). Returns K7's inputs
    (q, kp, vp, qpos, bt, ppos)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import flash_paged_decode_cuda, flash_paged_decode_ref

    B, S = SLOTS, MAX_LEN
    dense = serve["dense"]
    line(f"K6 ({B} slots x {S}, {H}/{KV}, {dh})",
         *k6_inputs(gen, H, KV, dh, PROMPT_LEN + MID_DECODE, window),
         f"{dense['counts'].get('flash_decode', 0)} launches serving "
         f"({dense['stats']['decode_steps']} steps)")
    q = _randn((B, 1, H, dh), gen)
    qt = q.transpose(1, 2)
    fill = [PROMPT_LEN + MID_DECODE + 1] * B           # mid-generation, 17 pages each
    kp, vp, bt, ppos = paged_inputs(gen, B, 18, PAGE, KV, dh, fill, n_mapped=17)
    qpos = torch.full((B,), fill[0] - 1, dtype=torch.int32, device="cuda")
    mask = paged_visible(bt, ppos, qpos, window)[:, None]
    kx, vx = (t[bt.clamp_min(0).long()].reshape(B, -1, KV, dh).repeat_interleave(
        H // KV, dim=2).transpose(1, 2) for t in (kp, vp))
    paged = serve["paged"]
    line(f"K7 ({B} slots x 17 pages of {PAGE}, {H}/{KV}, {dh})",
         lambda: flash_paged_decode_cuda(q, kp, vp, qpos, bt, ppos, window=window),
         lambda: flash_paged_decode_ref(q, kp, vp, qpos, bt, ppos, window=window),
         lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask),
         paged_work(bt, ppos, qpos, H, KV, dh, 2 * dh, dh, window=window),
         f"{paged['counts'].get('flash_paged_decode', 0)} launches paged serving "
         f"({paged['stats']['decode_steps']} steps)")
    return q, kp, vp, qpos, bt, ppos


_FLUSH = []


def _flush_buffer():
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda"))
    return _FLUSH[0]


def phase_numbers(gen, counts, stats, smi, err3, err6, peak):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd_cuda,
                                                     flash_attention_fwd_ref)

    # K3 at the slice's prefill shape
    B, L, H, KV, dh = 1, PROMPT_LEN, 16, 8, 128
    q, k, v = _randn((B, L, H, dh), gen), _randn((B, L, KV, dh), gen), _randn((B, L, KV, dh), gen)
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (k, v))
    qt = q.transpose(1, 2)
    k3 = _kernel_row(
        "flash_attention_fwd (K3, bf16 tensor-core route)", K3_SOURCE, K3_REPLACES,
        counts.get("flash_attention_fwd", 0), err3,
        lambda: flash_attention_fwd_cuda(q, k, v, causal=True),
        lambda: flash_attention_fwd_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True),
        k3_work(B, L, H, KV, dh, causal=True, window=0, itemsize=2))

    # K6 at the slice's decode shape: 8 slots of 1089, mid-generation
    k6 = _kernel_row("flash_decode (K6, split over the keys)", K6_SOURCE, K6_REPLACES,
                     counts.get("flash_decode", 0), err6,
                     *k6_inputs(gen, H, KV, dh, PROMPT_LEN + MID_DECODE))

    tag = f"[{smi}]"
    for row, key in ((k3, "K3 serving"), (k6, "K6")):
        was = timing_note(row, key)
        print(f"[numbers] {row['name']}: {row['ms']:.4f} ms/call{was} | plain "
              f"{row['plain_ms']:.4f} ms | SDPA {row['library_ms']:.4f} ms | bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | {row['launches']} "
              f"launches on the main path {tag}")
    from repro_torch.configs import get_config

    n_layers = get_config(ARCH).n_layers
    step_ms = 1e3 * stats["decode_s"] / max(1, stats["decode_steps"])
    prefill_ms = 1e3 * stats["prefill_s"] / max(1, stats["prefill_count"])
    print(f"[numbers] prefill {stats['prefill_tok_s']:.1f} tok/s "
          f"({prefill_ms:.2f} ms per {PROMPT_LEN}-token prefill; K3 x{n_layers} = "
          f"{n_layers * k3['ms']:.2f} ms of it) {tag}")
    print(f"[numbers] decode {stats['decode_tok_s']:.1f} tok/s | p50 "
          f"{stats['p50_token_latency_ms']:.3f} ms | p95 "
          f"{stats['p95_token_latency_ms']:.3f} ms per step | {step_ms:.3f} ms per "
          f"step, K6 x{n_layers} = {n_layers * k6['ms']:.3f} ms of it {tag}")
    print(f"[numbers] peak torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB "
          f"| kv capacity {stats['cache/kv_capacity_mb']:.1f} MiB {tag}")
    return [k3, k6]


# ---------------------------------------------------------------------------
# paged serving slice
# ---------------------------------------------------------------------------
def paged_inputs(gen, B, nb, ps, KV, w, fill, *, dtype=None, hole=False, ring=0,
                 n_mapped=None):
    """A page pool of (B * nb + 3) pages of ``ps`` rows, each batch row's
    first ``n_mapped`` (default nb) blocks at shuffled page ids, ``fill[b]``
    tokens written (wrapped into a ring of nb * ps slots when ``ring``),
    stale random positions on the spare pages; ``hole`` unmaps row 0's
    block 1. Returns (k_pages, v_pages, block_table, page_pos); ``dtype``
    torch.int8 gives int pages of width ``w``."""
    import torch

    n_pages = B * nb + 3
    n_mapped = nb if n_mapped is None else n_mapped
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (n_pages, ps, KV, w), generator=gen, device="cuda",
                              dtype=torch.int8) for _ in range(2))
    else:
        k, v = (_randn((n_pages, ps, KV, w), gen, dtype) for _ in range(2))
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    bt = torch.full((B, nb), -1, dtype=torch.int32, device="cuda")
    bt[:, :n_mapped] = perm[:B * n_mapped].reshape(B, n_mapped).to(torch.int32)
    ppos = torch.randint(0, nb * ps, (n_pages, ps), generator=gen, device="cuda")
    slots = torch.arange(nb * ps, device="cuda").reshape(nb, ps)
    for b in range(B):
        n = int(fill[b])
        last = n - 1 - ((n - 1 - slots) % (nb * ps)) if ring else slots
        ppos[bt[b, :n_mapped].long()] = torch.where((last >= 0) & (last < n), last,
                                                    -1)[:n_mapped]
    if hole:
        bt[0, 1] = -1
    return k, v, bt, ppos.to(torch.int32)


def paged_visible(bt, ppos, qpos, window):
    """(B, Lq, nb * ps) keys each query row sees (mapped page, position
    written, causal, in the window)."""
    B = bt.shape[0]
    spos = ppos[bt.clamp_min(0).long()].masked_fill(bt[..., None] < 0, -1).reshape(B, -1)
    qp = qpos.reshape(B, -1)[:, :, None]
    vis = (spos[:, None] >= 0) & (spos[:, None] <= qp)
    if window:
        vis &= qp - spos[:, None] < window
    return vis


def paged_work(bt, ppos, qpos, H, KV, dot_w, row_bytes, dh, *, window=0):
    """(flops, bytes) of one K7 / K8 call on this data: 4 * dot_w per
    visible (query row, key) pair and head; the K/V rows that some query
    row of their slot sees (``row_bytes`` per row and kv head, scales
    included) read once; the mapped pages' page_pos (every row of them:
    it decides what is seen), the block table and q read once; the output
    written once."""
    vis = paged_visible(bt, ppos, qpos, window)
    B, Lq = vis.shape[:2]
    rows = int((bt >= 0).sum()) * ppos.shape[1]
    seen = int(vis.any(1).sum())
    flops = 4.0 * dot_w * int(vis.sum()) * H
    nbytes = 2 * seen * KV * row_bytes + rows * 4 + bt.numel() * 4 + 2 * B * Lq * H * dh * 2
    return flops, nbytes


def _paged_err(o, o_r, bt, ppos, qpos, window):
    """(max |o - o_ref|, worst row rel) over the rows that see a key; a
    fully masked (parked) row must only be finite."""
    seen = paged_visible(bt, ppos, qpos, window).any(-1)
    return ((o[seen].float() - o_r[seen].float()).abs().max().item(),
            row_err(o[seen], o_r[seen]))


def phase_k7_k8(gen):
    """K7 and K8 against their plain versions at the serving shape (8 slots
    x 17 mapped pages of 64 of an 18-block table, H 16 / KV 8, dh 128,
    bf16), and around it. Returns the largest errors."""
    errs = {"K7": 0.0, "K8": 0.0}
    cases = [
        # label, dh (stored width), Lq, hole, ring/window, scale, quant (bits, ngr),
        # K7's and K8's split count (None: from the shapes, 5 splits of 4 pages here)
        ("shuffled, row 3 parked", 128, 1, False, 0, None, None, None),
        ("a hole", 128, 1, True, 0, None, None, None),
        ("ring of 256, window 256", 128, 1, False, 256, None, None, None),
        ("Lq 5", 128, 5, False, 0, None, None, None),
        ("dh 80", 80, 1, True, 0, None, None, None),
        ("dh 120", 120, 1, False, 0, None, None, None),
        ("svd r 64, dh-128 scale", 64, 1, False, 0, 128 ** -0.5, None, None),
        ("18 splits of a page: the hole's split has no page", 128, 1, True, 0, None, None, 18),
        ("3 splits of 6 pages, Lq 5", 128, 5, False, 0, None, None, 3),
        ("1 split", 128, 1, True, 0, None, None, 1),
        ("int8 ngr 1", 128, 1, True, 0, None, (8, 1), None),
        ("int8 ngr 4", 128, 5, False, 0, None, (8, 4), None),
        ("int4 ngr 1", 128, 1, False, 0, None, (4, 1), None),
        ("int4 ngr 4", 128, 5, True, 0, None, (4, 4), None),
        ("int8, 18 splits of a page: the hole's split has no page", 128, 1, True, 0, None,
         (8, 1), 18),
        ("int4 ngr 4, 3 splits of 6 pages, Lq 5", 128, 5, False, 0, None, (4, 4), 3),
        ("int8 ngr 4, 1 split", 128, 1, True, 0, None, (8, 4), 1),
    ]
    for case in cases:
        name, e = check_paged(gen, *case)
        errs[name] = max(errs[name], e)
    return errs


def check_paged(gen, label, dh, Lq, hole, ring, scale, quant, splits, H=16, KV=8):
    """K7 (or K8 with ``quant`` = (bits, groups)) against its plain version
    at the serving shape: 8 slots x 17 mapped pages of 64 of an 18-block
    table (a ring of ``ring`` slots, the window, when ``ring``: 600 tokens
    written, or ring + 300 past 300), row 3 parked; two launches bitwise
    equal. Returns (kernel, max |o - o_ref|)."""
    import torch

    from repro_torch.kernels.flash_decode import (flash_paged_decode_cuda,
                                                  flash_paged_decode_quant_cuda,
                                                  flash_paged_decode_quant_ref,
                                                  flash_paged_decode_ref, quantize_kv)

    B, nb = SLOTS, 18
    nbx = ring // PAGE if ring else nb
    fill = [max(600, ring + 300)] * B if ring else [1088 - 97 * b for b in range(B)]
    window = ring
    q = _randn((B, Lq, H, dh), gen)
    qpos = (torch.tensor(fill, device="cuda")[:, None] - Lq
            + torch.arange(Lq, device="cuda")[None]).to(torch.int32)
    qpos[3, 0] = -1                                   # a parked row
    k, v, bt, ppos = paged_inputs(gen, B, nbx, PAGE, KV, dh, fill, hole=hole, ring=ring,
                                  n_mapped=None if ring else 17)
    if quant is None:
        kw = dict(window=window, scale=scale)
        with k7_split_count(splits):
            o = flash_paged_decode_cuda(q, k, v, qpos, bt, ppos, **kw)
            again = flash_paged_decode_cuda(q, k, v, qpos, bt, ppos, **kw)
        o_r = flash_paged_decode_ref(q, k, v, qpos, bt, ppos, **kw)
        name = "K7"
    else:
        bits, ngr = quant
        (kq, ks), (vq, vs) = (quantize_kv(t, bits, ngr) for t in (k, v))
        with k7_split_count(splits):                  # K8 splits as K7 does
            o = flash_paged_decode_quant_cuda(q, kq, vq, ks, vs, qpos, bt, ppos,
                                              window=window)
            again = flash_paged_decode_quant_cuda(q, kq, vq, ks, vs, qpos, bt, ppos,
                                                  window=window)
        o_r = flash_paged_decode_quant_ref(q, kq, vq, ks, vs, qpos, bt, ppos, window=window)
        name = "K8"
    check(torch.equal(o, again), f"{name}: a second launch gave other bits ({label})")
    e, e_r = _paged_err(o, o_r, bt, ppos, qpos, window)
    print(f"[{name}] B={B} nb={nbx} ps={PAGE} H={H} KV={KV} w={dh} Lq={Lq} ({label}) bf16: "
          f"max|o-o_ref|={e:.3e} (tol {TOL_O}) worst row rel {e_r:.3e} (tol {TOL_ROW}); "
          f"two launches bitwise equal")
    check(bool(o.isfinite().all()), f"{name} output not finite ({label})")
    check(e <= TOL_O and e_r <= TOL_ROW, f"{name} disagrees with its plain version ({label})")
    return name, e


@contextlib.contextmanager
def k7_split_count(n):
    """K7 and K8 at ``n`` splits (at most one per table entry) inside the
    block, whatever the shapes give; None leaves the count to the shapes.
    The wrappers have no such option: their count is a function of the
    shapes."""
    from repro_torch.kernels import flash_decode

    real = flash_decode._splits

    def fixed(B, KV, nb, device):
        per = -(-nb // min(nb, n))
        return -(-nb // per), per

    if n is not None:
        flash_decode._splits = fixed
    try:
        yield
    finally:
        flash_decode._splits = real


@contextlib.contextmanager
def k2_split_count(n):
    """K2 (2-D or batched, n splits an expert) at ``n`` row splits (at most
    one a row) inside the block, whatever the shapes give; None leaves the
    count to the shapes, as the wrapper always does. The 2-D rule
    ``_splits`` is ``_splits_batched`` at one expert, so one swap holds
    both."""
    from repro_torch.kernels import pamm_apply

    real = pamm_apply._splits_batched

    def fixed(e, b, m, k):
        per = -(-b // n)
        return -(-b // per), per

    if n is not None:
        pamm_apply._splits_batched = fixed
    try:
        yield
    finally:
        pamm_apply._splits_batched = real


def _counted(drive):
    """Launch counts of ``drive()``: set to 0 just before, read just after."""
    import torch

    from repro_torch.kernels import launches

    torch.cuda.synchronize()
    launches.reset()
    out = drive()
    torch.cuda.synchronize()
    return out, launches.counts()


def first_divergence_near_tie(cfg, rcfg, model, req, want, got, what, tag="paged",
                              tol=TOL_NEAR):
    """Where two greedy streams of one request differ, the first
    divergence must sit at a near tie: a fresh prefill over the prompt and
    the shared tokens has a top-2 margin below ``tol`` (the dense phase's
    0.25). Returns the index of the first divergence or None."""
    import torch

    from repro_torch.models import prefill

    diff = [t for t in range(min(len(want), len(got))) if want[t] != got[t]]
    if not diff:
        return None
    t = diff[0]
    seq = torch.tensor([list(req.tokens) + want[:t]], device="cuda")
    logits, _ = prefill(cfg, rcfg, model, request_batch(req, seq), seq.shape[1])
    top2 = logits[0, -1, : cfg.vocab_size].topk(2).values
    margin = float(top2[0] - top2[1])
    print(f"[{tag}] {what}: request {req.uid} first differs at token {t}, top-2 margin "
          f"{margin:.4f}")
    check(margin < tol, f"{what}: request {req.uid} diverged at token {t} at a margin of "
                        f"{margin:.3f}, not a near tie (< {tol})")
    return t


def request_batch(req, seq) -> dict:
    """A batch of one request's tokens ``seq`` (1, L) on the card, with
    its image embeddings where it has them (a vision arch)."""
    import torch

    batch = {"tokens": seq}
    if req.image_embeds is not None:
        batch["image_embeds"] = torch.as_tensor(req.image_embeds, device="cuda")[None]
    return batch


def teacher_forced(cfg, rcfg, model, req, tokens, what, tol=TOL_NEAR):
    """Every token of a greedy stream against the argmax of one forward
    pass over the prompt and the stream's own earlier tokens (K3 only, or
    no kernel for an ssm arch): where they differ, the emitted token's
    logit must lie within ``tol`` of the forward's largest (the dense
    phase's near-tie margin, 0.25). Returns (differences, largest such
    gap)."""
    import torch

    from repro_torch.core.keys import Key
    from repro_torch.models import forward

    seq = torch.tensor([list(req.tokens) + tokens[:-1]], device="cuda")
    with torch.no_grad():
        h, _ = forward(cfg, rcfg, None, model, request_batch(req, seq), Key(0))
        rows = (h[0, len(req.tokens) - 1:] @ model.head.to(h.dtype)).float()
    rows = rows[:, : cfg.vocab_size]
    check(bool(torch.isfinite(rows).all()), f"{what}: non-finite teacher-forced logits")
    got = torch.tensor(tokens, device=rows.device)
    gap = (rows.max(-1).values - rows.gather(1, got[:, None])[:, 0]).cpu()
    diff = (rows.argmax(-1) != got).nonzero().flatten().tolist()
    worst = max((float(gap[t]) for t in diff), default=0.0)
    check(worst < tol, f"{what}: request {req.uid} disagrees with the teacher-forced "
                       f"argmax at a margin of {worst:.3f}, not a near tie (< {tol})")
    return len(diff), worst


def phase_paged_serving(dense, smi):
    """Paged fp serving of the dense phase's requests: tokens against the
    dense run, launch counts (K7 = 24 x decode steps, K6 0, no plain
    version), a second run, peak memory, a profiler split of one decode
    block."""
    import torch

    from repro_torch.serve import ServeEngine

    cfg, rcfg, model = dense["cfg"], dense["rcfg"], dense["model"]
    engine = lambda: ServeEngine(cfg, rcfg, model, max_slots=SLOTS, max_len=MAX_LEN,
                                 decode_block=DECODE_BLOCK, cache_layout="paged",
                                 page_size=PAGE)
    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    out, counts = _counted(lambda: eng.run(_requests(cfg)))
    peak = torch.cuda.max_memory_allocated()
    stats = eng.stats()
    check(sorted(out) == list(range(N_REQUESTS)) and stats["nonfinite_logits"] == 0,
          "paged fp: a request did not finish or logits were not finite")
    for a in eng.allocators:
        a.check_invariant()
        check(a.free_pages == a.spec.n_pages, "paged fp: pages stayed reserved")
    n = cfg.n_layers
    print(f"[paged] fp launches {counts} | prefills {stats['prefill_count']} | decode steps "
          f"{stats['decode_steps']} | pages {eng.allocators[0].spec.n_pages}")
    check(counts.get("flash_paged_decode", 0) == n * stats["decode_steps"]
          and counts.get("flash_attention_fwd", 0) == n * stats["prefill_count"]
          and counts.get("flash_attention_fwd_f32", 0) == 0
          and counts.get("flash_decode", 0) == 0
          and not any(k.endswith("_ref") for k in counts),
          "paged fp launches: want K7 = 24 x decode steps, K3 = 24 x prefills, K6 0, plain 0")
    again = engine().run(_requests(cfg))
    check(all(again[u].tokens == out[u].tokens for u in out), "paged fp: a second run differs")
    same = [u for u in out if out[u].tokens == dense["tokens"][u]]
    print(f"[paged] fp tokens equal to the dense run's for {len(same)}/{N_REQUESTS} requests "
          f"(greedy and sampled); second run identical")
    # a greedy stream may differ only from a near tie on; a sampled one
    # follows its uniforms wherever the logits moved, so it is reported only
    greedy = [r for r in _requests(cfg) if r.sampling.temperature == 0]
    for r in greedy:
        if r.uid not in same:
            first_divergence_near_tie(cfg, rcfg, model, r, dense["tokens"][r.uid],
                                      out[r.uid].tokens, "paged vs dense")
    # past the first divergence too: every token of each greedy stream
    tf = [teacher_forced(cfg, rcfg, model, r, out[r.uid].tokens, "paged fp") for r in greedy]
    print(f"[paged] fp: every token of the {len(greedy)} greedy streams vs a teacher-forced "
          f"forward over its own tokens: {sum(n for n, _ in tf)} of "
          f"{sum(len(out[r.uid].tokens) for r in greedy)} differ, their largest gap to the "
          f"top logit {max(w for _, w in tf):.4f} (near tie < 0.25)")
    print(f"[paged] peak torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB (dense run "
          f"{dense['peak'] / 2**30:.3f} GiB) | kv capacity paged "
          f"{stats['cache/kv_capacity_mb']:.1f} MiB, dense {dense['kv_mb']:.1f} MiB | "
          f"decode {stats['decode_tok_s']:.1f} tok/s, p50 "
          f"{stats['p50_token_latency_ms']:.3f} / p95 {stats['p95_token_latency_ms']:.3f} ms "
          f"per step [{smi}]")
    trace_breakdown(cfg, engine, model, {
        "decode block": 1e3 * stats["decode_s"] / max(1, stats["decode_steps"]) * DECODE_BLOCK},
        tag="paged ")
    del eng
    torch.cuda.empty_cache()
    return counts, stats, {u: out[u].tokens for u in out}


def _spliced_logits(cfg, rcfg, model, spec, prefix):
    """One decode step's logits after splicing a batch-1 prefill cache
    into slot 0 of a fresh paged tree of format ``spec`` (slot 1 parked),
    as tests/test_kvquant.py holds the formats to fp."""
    import numpy as np
    import torch

    from repro_torch.core.plan import cache_plan_from_spec
    from repro_torch.models import decode_step, init_caches
    from repro_torch.serve import cache as cache_lib

    full = init_caches(cfg, rcfg, 2, MAX_LEN, "cuda", layout="paged", page_size=PAGE,
                       cache_plan=cache_plan_from_spec(spec).resolve(cfg))
    if "svd" in spec:
        cache_lib.install_svd_bases(full, model, cfg)
    rows = [[np.arange(nd.block_table.shape[2], dtype=np.int32) for nd in st] for st in full]
    lp = prefix.prompt_len
    cache_lib.write_slot_paged(full, prefix.caches, rows, 0, lp)
    logits, _ = decode_step(cfg, rcfg, model,
                            torch.tensor([[prefix.first_token], [0]], device="cuda"),
                            torch.tensor([[lp], [-1]], dtype=torch.int32, device="cuda"), full)
    return logits[0, 0, : cfg.vocab_size].float()


def phase_compressed_pools(dense, smi):
    """fp, int8, int4 and svd(r=1/2) pools at one byte budget (pool_tokens
    = four requests' bf16 reservation): pages minted, admitted concurrency,
    allocator invariant and release, throughput; first spliced decode step
    against fp within the JAX bounds; K8 carries int8/int4, K7 svd; a
    profiler split of one int8 decode block of 8 slots."""
    import torch

    from repro_torch.serve import ServeEngine

    cfg, rcfg, model = dense["cfg"], dense["rcfg"], dense["model"]
    probe = ServeEngine(cfg, rcfg, model, max_slots=1, max_len=MAX_LEN, cache_layout="paged",
                        page_size=PAGE)
    prefix = probe.prefill(model, _requests(cfg)[0])
    del probe
    ref = _spliced_logits(cfg, rcfg, model, "", prefix)
    res = {}
    for spec in ("", "int8", "int4", "svd(r=1/2)"):
        eng = ServeEngine(cfg, rcfg, model, max_slots=SLOTS, max_len=MAX_LEN,
                          decode_block=DECODE_BLOCK, cache_layout="paged", page_size=PAGE,
                          pool_tokens=POOL_TOKENS, cache_compress=spec)
        out, counts = _counted(lambda: eng.run(_requests(cfg)))
        st = eng.stats()
        [alloc] = eng.allocators
        alloc.check_invariant()
        label = spec or "fp"
        check(sorted(out) == list(range(N_REQUESTS)) and st["nonfinite_logits"] == 0,
              f"{label} pool: a request did not finish or logits were not finite")
        check(alloc.free_pages == alloc.spec.n_pages, f"{label} pool: pages stayed reserved")
        want = ("flash_paged_decode_quant" if spec in ("int8", "int4")
                else "flash_paged_decode")
        check(counts.get(want, 0) == cfg.n_layers * st["decode_steps"]
              and not any(k.endswith("_ref") for k in counts)
              and sum(counts.get(k, 0) for k in ("flash_decode", "flash_paged_decode",
                                                 "flash_paged_decode_quant")) ==
              cfg.n_layers * st["decode_steps"],
              f"{label} pool launches {counts}: want {want} = {cfg.n_layers} x decode steps only")
        err = 0.0 if not spec else float((_spliced_logits(cfg, rcfg, model, spec, prefix)
                                          - ref).abs().max())
        tol = FORMAT_TOL.get(spec, 0.0)
        print(f"[paged] {label:>10}: {alloc.spec.n_pages} pages of {PAGE} "
              f"({alloc.spec.token_bytes} B/token over {cfg.n_layers} layers) | "
              f"kv_compression_x {eng.kv_compression_x:.3f} | peak concurrency "
              f"{st['peak_active']} | invariant holds, 0 pages reserved after the run | decode "
              f"{st['decode_tok_s']:.1f} tok/s, p50 {st['p50_token_latency_ms']:.3f} / p95 "
              f"{st['p95_token_latency_ms']:.3f} ms | first-step logits vs fp max |d| "
              f"{err:.4f}" + (f" (tol {tol})" if spec else "") + f" | launches {counts} [{smi}]")
        check(not spec or err < tol, f"{label} pool: first-step logits off fp by {err:.3f}")
        res[label] = {"peak_active": st["peak_active"], "counts": counts, "stats": st}
        del eng
        torch.cuda.empty_cache()
        if spec == "int8":      # K8's share of a decode block of 8 slots (the pool at 8 x 18 pages)
            trace_breakdown(cfg, lambda: ServeEngine(
                cfg, rcfg, model, max_slots=SLOTS, max_len=MAX_LEN, decode_block=DECODE_BLOCK,
                cache_layout="paged", page_size=PAGE, cache_compress="int8"), model, {
                "decode block": 1e3 * st["decode_s"] / max(1, st["decode_steps"]) * DECODE_BLOCK},
                tag="int8 paged ")
            torch.cuda.empty_cache()
    check(res["fp"]["peak_active"] == 4 and res["int8"]["peak_active"] > 4,
          f"admission: fp {res['fp']['peak_active']}, int8 {res['int8']['peak_active']} "
          f"(want 4 and more)")
    return res


def phase_prefix_and_spec(dense, paged_tokens, smi):
    """Prefix sharing (16 requests sharing a 768-token head, with the
    distinct 247-256-token tails of their own prompts, at the compressed
    phase's pool budget: shared tokens equal unshared ones, decode through
    K7) and speculative verify (the 12 greedy requests at k = 4: tokens
    equal sequential greedy up to a near tie at the first divergence, and
    every token of each stream equal to a teacher-forced forward's argmax
    up to a near tie; K7 at Lq 5 on every decode step)."""
    import torch

    from repro_torch.serve import Request, ServeEngine

    cfg, rcfg, model = dense["cfg"], dense["rcfg"], dense["model"]
    base = _requests(cfg)
    head = list(base[0].tokens[:SHARED_PREFIX])
    tails = [list(r.tokens[SHARED_PREFIX:]) for r in base]
    shared = lambda: [Request(uid=r.uid, tokens=head + tails[i], max_new_tokens=GEN,
                              sampling=r.sampling) for i, r in enumerate(base)]
    kw = dict(max_slots=SLOTS, max_len=MAX_LEN, decode_block=DECODE_BLOCK,
              cache_layout="paged", page_size=PAGE, pool_tokens=POOL_TOKENS)
    plain = ServeEngine(cfg, rcfg, model, **kw)
    out_u = plain.run(shared())
    eng = ServeEngine(cfg, rcfg, model, prefix_share=True, **kw)
    out_s, counts = _counted(lambda: eng.run(shared()))
    st = eng.stats()
    check(all(out_s[u].tokens == out_u[u].tokens for u in out_u),
          "prefix-shared tokens differ from the unshared run's")
    while eng._evict_one_retired():
        pass
    for a in eng.allocators:
        a.check_invariant()
        check(a.free_pages == a.spec.n_pages, "prefix sharing leaked pages")
    print(f"[paged] prefix sharing ({SHARED_PREFIX}-token head, distinct tails, pool "
          f"{POOL_TOKENS} tokens): tokens equal to the unshared run for {N_REQUESTS}/"
          f"{N_REQUESTS} | prefix_hits {st['prefix_hits']} | pages_adopted "
          f"{st['prefix_pages_adopted']} | cow_page_splits {st['cow_page_splits']} | peak "
          f"concurrency {st['peak_active']} shared vs {plain.peak_active} unshared | no page "
          f"leaked after evicting the retired prefixes | launches {counts} | decode "
          f"{st['decode_tok_s']:.1f} tok/s [{smi}]")
    check(st["prefix_hits"] >= N_REQUESTS - 1 and st["peak_active"] > plain.peak_active,
          "prefix sharing did not share")
    check(counts.get("flash_paged_decode", 0) == cfg.n_layers * st["decode_steps"]
          and counts.get("flash_decode", 0) == 0
          and not any(k.endswith("_ref") for k in counts),
          f"prefix sharing launches {counts}: want K7 = 24 x decode steps, K6 0, plain 0")
    del plain, eng
    torch.cuda.empty_cache()

    greedy = [r for r in _requests(cfg) if r.sampling.temperature == 0]
    spec_eng = ServeEngine(cfg, rcfg, model, max_slots=SLOTS, max_len=MAX_LEN,
                           decode_block=DECODE_BLOCK, cache_layout="paged", page_size=PAGE,
                           speculative_k=SPEC_K)
    out, counts = _counted(lambda: spec_eng.run(greedy))
    st = spec_eng.stats()
    firsts = {r.uid: first_divergence_near_tie(cfg, rcfg, model, r, paged_tokens[r.uid],
                                               out[r.uid].tokens, "speculative vs sequential")
              for r in greedy}
    # the whole of each stream, past its first divergence too
    tf = [teacher_forced(cfg, rcfg, model, r, out[r.uid].tokens, "speculative")
          for r in greedy]
    n_same = sum(t is None for t in firsts.values())
    print(f"[paged] speculative k={SPEC_K}, {len(greedy)} greedy requests: tokens equal to "
          f"sequential greedy for {n_same}/{len(greedy)}, first divergences at tokens "
          f"{sorted(t for t in firsts.values() if t is not None)} (near ties) | every token of "
          f"every stream vs a teacher-forced forward over its own tokens: "
          f"{sum(n for n, _ in tf)} of {sum(len(out[r.uid].tokens) for r in greedy)} differ, "
          f"their largest gap to the top logit {max(w for _, w in tf):.4f} (near tie < 0.25) | "
          f"verify calls {st['spec_verify_calls']} of {st['decode_steps']} decode steps, each "
          f"one decode_step over (B, {SPEC_K + 1}) rows | drafted "
          f"{st['spec_tokens_drafted']} accepted {st['spec_tokens_accepted']} (rate "
          f"{st['spec_accept_rate']:.3f}) | launches {counts} | decode "
          f"{st['decode_tok_s']:.1f} tok/s [{smi}]")
    # an all-greedy batch verifies on every decode step, so every K7 launch
    # of the run scored a verify block at Lq = k + 1
    check(st["spec_verify_calls"] > 0 and st["spec_verify_calls"] == st["decode_steps"]
          and st["nonfinite_logits"] == 0
          and counts.get("flash_paged_decode", 0) == cfg.n_layers * st["decode_steps"]
          and not any(k.endswith("_ref") for k in counts),
          "speculative verify did not run K7 at Lq = k + 1 on every verify call")
    del spec_eng
    torch.cuda.empty_cache()
    return st


def phase_paged_numbers(gen, paged_counts, pool_res, smi, errs):
    """K7 and K8 (int8, int4) in ms per call at the serving shape, beside
    the plain versions, the bound and the launches; SDPA over the same
    keys laid out densely (the gather not timed) as K7's yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (flash_paged_decode_cuda,
                                                  flash_paged_decode_quant_cuda,
                                                  flash_paged_decode_quant_ref,
                                                  flash_paged_decode_ref, quantize_kv)

    B, nb, H, KV, dh = SLOTS, 18, 16, 8, 128
    fill = [PROMPT_LEN + MID_DECODE + 1] * B           # mid-generation, 17 pages each
    k, v, bt, ppos = paged_inputs(gen, B, nb, PAGE, KV, dh, fill, n_mapped=17)
    q = _randn((B, 1, H, dh), gen)
    qpos = torch.full((B,), fill[0] - 1, dtype=torch.int32, device="cuda")
    btc = bt.clamp_min(0).long()
    kd, vd = (t[btc].reshape(B, -1, KV, dh) for t in (k, v))
    mask = paged_visible(bt, ppos, qpos, 0)[:, None]
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (kd, vd))
    qt = q.transpose(1, 2)
    rows = [_kernel_row(
        "flash_paged_decode (K7, split over the keys)", K78_SOURCE, K7_REPLACES,
        paged_counts.get("flash_paged_decode", 0), errs["K7"],
        lambda: flash_paged_decode_cuda(q, k, v, qpos, bt, ppos),
        lambda: flash_paged_decode_ref(q, k, v, qpos, bt, ppos),
        lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask),
        paged_work(bt, ppos, qpos, H, KV, dh, 2 * dh, dh))]
    for bits, label in ((8, "int8"), (4, "int4")):
        (kq, ks), (vq, vs) = (quantize_kv(t, bits, 1) for t in (k, v))
        rows.append(_kernel_row(
            f"flash_paged_decode_quant (K8, {label}, split over the keys)", K78_SOURCE,
            K8_REPLACES,
            pool_res[label]["counts"].get("flash_paged_decode_quant", 0), errs["K8"],
            lambda: flash_paged_decode_quant_cuda(q, kq, vq, ks, vs, qpos, bt, ppos),
            lambda: flash_paged_decode_quant_ref(q, kq, vq, ks, vs, qpos, bt, ppos), None,
            paged_work(bt, ppos, qpos, H, KV, dh, kq.shape[-1] + 4 * ks.shape[-1], dh)))
    for row, key in zip(rows, ("K7", "K8 int8", "K8 int4")):
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms (SDPA over the keys laid out densely)")
        was = timing_note(row, key)
        print(f"[numbers] {row['name']}: {row['ms']:.4f} ms/call{was} | plain {row['plain_ms']:.4f} "
              f"ms | library {lib} | bound {row['bound_ms']:.4f} ms ({row['bound_by']}) | "
              f"{row['launches']} launches on its serving run [{smi}]")
    return rows


# ---------------------------------------------------------------------------
# serving front: a Router over replicas on one card, and serve_step
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _timed_to_host(times: list):
    """Host-clock ms of every ``Prefix.to_host()`` (the hand-off's copy of
    a prefill cache to the host) made inside the block."""
    import torch

    from repro_torch.serve.engine import Prefix

    real = Prefix.to_host

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self)
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    Prefix.to_host = timed
    try:
        yield
    finally:
        Prefix.to_host = real


def _front_serve(cfg, front, replicas, prefill_engines, label):
    """Serve the phase-4 requests at FRONT_GEN new tokens through ``front``
    (a Router or one engine) with the launch counts set to 0 just before
    and read just after; check that every request finished with finite
    logits and no page stayed reserved, and the launches: K3 = layers x 16
    prefills, K7 = layers x the replicas' summed decode steps, K6, the f32
    route and every plain version 0. Returns what the phase prints."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    handoff: list[float] = []
    with _timed_to_host(handoff):
        t0 = time.perf_counter()
        out, counts = _counted(lambda: front.run(_requests(cfg, FRONT_GEN)))
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    per = [e.stats() for e in replicas]
    check(sorted(out) == list(range(N_REQUESTS))
          and all(len(out[u].tokens) == FRONT_GEN for u in out),
          f"{label}: a request did not finish with {FRONT_GEN} tokens")
    check(sum(e.nonfinite_logits for e in replicas + prefill_engines) == 0,
          f"{label}: non-finite logits")
    for e in replicas:
        for a in e.allocators:
            a.check_invariant()
            check(a.free_pages == a.spec.n_pages, f"{label}: pages stayed reserved")
    n = cfg.n_layers
    steps = sum(s["decode_steps"] for s in per)
    prefills = sum(e.prefill_count for e in replicas + prefill_engines)
    check(prefills == N_REQUESTS
          and counts.get("flash_attention_fwd", 0) == n * N_REQUESTS
          and counts.get("flash_paged_decode", 0) == n * steps
          and counts.get("flash_attention_fwd_f32", 0) == 0
          and counts.get("flash_decode", 0) == 0
          and not any(k.endswith("_ref") for k in counts),
          f"{label}: launches {counts}, {prefills} prefills: want K3 = {n} x {N_REQUESTS} "
          f"prefills, K7 = {n} x {steps} decode steps, K6, f32 route and plain 0")
    st = front.stats()
    dec_tokens = sum(s["decode_tokens"] for s in per)
    inserts = sum(s["insert_count"] for s in per)
    return {"tokens": {u: out[u].tokens for u in out}, "counts": counts, "wall": wall,
            "peak": peak, "steps": steps, "stats": st, "decode_tokens": dec_tokens,
            "wall_tok_s": dec_tokens / wall,
            "insert_ms": 1e3 * sum(s["insert_s"] for s in per) / max(1, inserts),
            "handoff_ms": handoff,
            "peak_active": st.get("peak_active_aggregate", st.get("peak_active"))}


def _front_line(label, r, smi):
    st = r["stats"]
    print(f"[front] {label}: peak aggregate concurrency {r['peak_active']} | decode_tok_s "
          f"(reference: summed tokens / largest replica decode wall) "
          f"{st['decode_tok_s']:.1f} | wall aggregate {r['wall_tok_s']:.1f} tok/s "
          f"({r['decode_tokens']} decode tokens / {r['wall']:.3f} s of run) | prefill "
          f"{st['prefill_tok_s']:.1f} tok/s | insert {r['insert_ms']:.2f} ms avg | peak "
          f"{r['peak'] / 2**30:.3f} GiB | decode steps {r['steps']} | launches "
          f"{r['counts']} [{smi}]")


def _front_tokens(cfg, rcfg, model, label, got, base, base_label):
    """Tokens of one front run against another's: sampled requests bitwise
    equal (their draws are a function of (seed, index)); each greedy one
    equal, or else diverging first at a near tie and held, token by token,
    to a teacher-forced forward (the paged phase's rule)."""
    reqs = _requests(cfg, FRONT_GEN)
    for r in reqs:
        if r.sampling.temperature > 0:
            check(got[r.uid] == base[r.uid],
                  f"{label}: sampled request {r.uid} differs from {base_label}")
    near = [r for r in reqs if r.sampling.temperature == 0 and got[r.uid] != base[r.uid]]
    for r in near:
        first_divergence_near_tie(cfg, rcfg, model, r, base[r.uid], got[r.uid],
                                  f"{label} vs {base_label}", tag="front")
        teacher_forced(cfg, rcfg, model, r, got[r.uid], label)
    held = ("exact equality" if not near else
            f"near ties: greedy requests {[r.uid for r in near]} first differ at a top-2 "
            f"margin < 0.25 and agree with a teacher-forced forward")
    print(f"[front] {label} tokens vs {base_label}: "
          f"{sum(got[u] == base[u] for u in base)}/{N_REQUESTS} equal; held by {held}")


def phase_serving_front(dense, smi):
    """Routers over 1, 2 and 4 paged fp replicas at a fixed pool of
    FRONT_POOL tokens each (aggregate concurrency 2 / 4 / 8; tokens
    against the 1-replica run), 2 replicas behind a dedicated prefill
    engine (tokens equal the 2-replica run's, no replica prefills, the
    hand-off timed), one engine holding the 4-replica budget as the
    yardstick, and a profiler split of one router step at 4 replicas."""
    import torch

    from repro_torch.serve import Router, ServeEngine

    cfg, rcfg, model = dense["cfg"], dense["rcfg"], dense["model"]
    t_phase = time.perf_counter()

    def engine(slots=SLOTS, pool=FRONT_POOL):
        return ServeEngine(cfg, rcfg, model, max_slots=slots, max_len=MAX_LEN,
                           decode_block=DECODE_BLOCK, cache_layout="paged", page_size=PAGE,
                           pool_tokens=pool)

    print(f"[front] {N_REQUESTS} requests of ~{PROMPT_LEN} prompt and {FRONT_GEN} new tokens "
          f"(12 greedy, 4 sampled); replicas of {SLOTS} slots and a fixed pool of "
          f"{FRONT_POOL} tokens ({FRONT_POOL // PAGE} pages of {PAGE}) each")
    runs = {}
    for n_rep in FRONT_REPLICAS:
        replicas = [engine() for _ in range(n_rep)]
        router = Router(replicas)
        label = f"{n_rep} replica{'s' if n_rep > 1 else ''}"
        runs[n_rep] = r = _front_serve(cfg, router, replicas, [], label)
        _front_line(label, r, smi)
        check(r["peak_active"] == 2 * n_rep,
              f"{label}: peak aggregate concurrency {r['peak_active']}, want {2 * n_rep}")
        if n_rep > 1:
            _front_tokens(cfg, rcfg, model, label, r["tokens"], runs[1]["tokens"],
                          "1 replica")
        del router, replicas
    print(f"[front] aggregate concurrency 1 -> {FRONT_REPLICAS[-1]} replicas: "
          f"{runs[FRONT_REPLICAS[-1]]['peak_active'] / runs[1]['peak_active']:.1f}x "
          f"(the reference's acceptance: >= 3x); wall aggregate "
          + " / ".join(f"{runs[k]['wall_tok_s']:.1f}" for k in FRONT_REPLICAS)
          + " tok/s, reference decode_tok_s "
          + " / ".join(f"{runs[k]['stats']['decode_tok_s']:.1f}" for k in FRONT_REPLICAS)
          + f" at {' / '.join(map(str, FRONT_REPLICAS))} replicas [{smi}]")

    replicas, pf = [engine() for _ in range(2)], engine(slots=1)
    label = "2 replicas + dedicated prefill"
    r = _front_serve(cfg, Router(replicas, prefill_engine=pf), replicas, [pf], label)
    _front_line(label, r, smi)
    check(all(r["tokens"][u] == runs[2]["tokens"][u] for u in r["tokens"]),
          f"{label}: tokens differ from the 2-replica run's")
    check(all(e.prefill_count == 0 for e in replicas) and pf.prefill_count == N_REQUESTS
          and len(r["handoff_ms"]) == N_REQUESTS,
          f"{label}: a decode replica prefilled, or a Prefix skipped the host hand-off")
    pf_ms = 1e3 * pf.prefill_time / pf.prefill_count
    to_host = statistics.median(r["handoff_ms"])
    print(f"[front] {label}: tokens equal to the 2-replica run's for {N_REQUESTS}/{N_REQUESTS}; "
          f"decode replicas' prefill_count {[e.prefill_count for e in replicas]}, prefill "
          f"engine's {pf.prefill_count} | hand-off per request: to_host {to_host:.2f} ms "
          f"(median; mean {statistics.mean(r['handoff_ms']):.2f}) + insert "
          f"{r['insert_ms']:.2f} ms = {to_host + r['insert_ms']:.2f} ms, against a prefill "
          f"of {pf_ms:.2f} ms [{smi}]")
    del replicas, pf

    yard = engine(pool=FRONT_REPLICAS[-1] * FRONT_POOL)
    label = f"one engine, {SLOTS} slots, pool {FRONT_REPLICAS[-1]} x {FRONT_POOL} (yardstick)"
    r = _front_serve(cfg, yard, [yard], [], label)
    _front_line(label, r, smi)
    check(r["peak_active"] == SLOTS, f"yardstick: peak concurrency {r['peak_active']}")
    _front_tokens(cfg, rcfg, model, "yardstick", r["tokens"], runs[1]["tokens"], "1 replica")
    last = runs[FRONT_REPLICAS[-1]]
    print(f"[front] yardstick wall aggregate {r['wall_tok_s']:.1f} tok/s = "
          f"{r['wall_tok_s'] / last['wall_tok_s']:.2f}x the {FRONT_REPLICAS[-1]}-replica "
          f"router's {last['wall_tok_s']:.1f} at the same pool bytes [{smi}]")
    del yard

    # one steady router step at 4 replicas x 2 active: each replica one block
    replicas = [engine() for _ in range(FRONT_REPLICAS[-1])]
    router = Router(replicas)
    for req in _requests(cfg, FRONT_GEN)[:2 * len(replicas)]:
        router.submit(req)
    router.step()                                 # admissions and the first blocks
    torch.cuda.synchronize()
    check(all(int(e.active.sum()) == 2 for e in replicas),
          "router step: a replica does not hold 2 active requests")
    t0 = time.perf_counter()
    router.step()
    torch.cuda.synchronize()
    base_ms = 1e3 * (time.perf_counter() - t0)
    groups = profile_split(f"router step, {len(replicas)} replicas x 2 active, one decode "
                           f"block each", router.step, base_ms, tag="front ")
    k7 = groups.get("K7/K8", 0.0)
    print(f"[front] router step at {len(replicas)} replicas: {base_ms:.2f} ms wall, "
          f"{len(replicas)} host syncs; K7 {k7:.3f} ms and all kernels "
          f"{sum(groups.values()):.3f} ms of device time, the rest "
          f"{base_ms - sum(groups.values()):.2f} ms host [{smi}]")
    del router, replicas
    torch.cuda.empty_cache()
    print(f"[front] Router runs and trace: {time.perf_counter() - t_phase:.1f} s")
    return runs


def phase_serve_step(dense, smi):
    """``train.serve_step``: greedy_decode (the engine's decode blocks)
    against greedy_decode_per_token (one batched prefill, then a Python
    loop of decode_step) on the first 8 prompts at 1024 tokens,
    SERVE_STEP_STEPS steps, dense: tokens up to near ties, the launches,
    and the wall ms per decode step of each, (wall at n steps - wall at 1
    step) / (n - 1), over
    rounds whose order alternates: median and quartiles, and of the
    loop / engine ratio within a round."""
    import numpy as np
    import torch

    from repro_torch.data import SyntheticStream
    from repro_torch.serve import Request
    from repro_torch.train import greedy_decode, greedy_decode_per_token

    cfg, rcfg, model = dense["cfg"], dense["rcfg"], dense["model"]
    t_phase = time.perf_counter()
    B, steps, n = SERVE_STEP_ROWS, SERVE_STEP_STEPS, cfg.n_layers
    toks = np.asarray(SyntheticStream.for_arch(cfg, PROMPT_LEN, N_REQUESTS)
                      .get_batch(0)["tokens"])[:B, :PROMPT_LEN]
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}

    def timed(fn, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(cfg, rcfg, model, batch, steps=k, max_len=MAX_LEN)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    fns = {"greedy_decode": (greedy_decode, n * B),
           "greedy_decode_per_token": (greedy_decode_per_token, n)}
    for fn, _ in fns.values():                  # warm both paths' shapes
        timed(fn, 1)
    # rounds of (1 step, 64 steps) per path, the paths' order alternating
    # (the host's speed drifts within a call); each sample is
    # (wall at 64 - wall at 1 just before it) / 63
    res = {name: {"ms": []} for name in fns}
    for i in range(SERVE_STEP_ROUNDS):
        for name in list(fns)[:: 1 if i % 2 == 0 else -1]:
            fn, k3 = fns[name]
            w1 = timed(fn, 1)[1]
            (out, w), counts = _counted(lambda: timed(fn, steps))
            check(tuple(out.shape) == (B, steps) and out.dtype == torch.int64,
                  f"{name}: tokens of shape {tuple(out.shape)} {out.dtype}")
            check(counts.get("flash_attention_fwd", 0) == k3
                  and counts.get("flash_decode", 0) == n * (steps - 1)
                  and counts.get("flash_attention_fwd_f32", 0) == 0
                  and counts.get("flash_paged_decode", 0) == 0
                  and not any(c.endswith("_ref") for c in counts),
                  f"{name}: launches {counts}: want K3 {k3}, K6 {n} x {steps - 1}, plain 0")
            tokens = out.cpu().tolist()
            check(res[name].setdefault("tokens", tokens) == tokens,
                  f"{name}: a second call gave other tokens")
            res[name]["counts"] = counts
            res[name]["ms"].append(1e3 * (w - w1) / (steps - 1))
    fused, loop = res["greedy_decode"]["tokens"], res["greedy_decode_per_token"]["tokens"]
    reqs = [Request(uid=i, tokens=toks[i].tolist(), max_new_tokens=steps) for i in range(B)]
    for r in reqs:
        if fused[r.uid] != loop[r.uid]:
            first_divergence_near_tie(cfg, rcfg, model, r, loop[r.uid], fused[r.uid],
                                      "greedy_decode vs per-token loop", tag="front")
    tf = [teacher_forced(cfg, rcfg, model, r, t[r.uid], "serve_step")
          for t in (fused, loop) for r in reqs]
    quart = {name: statistics.quantiles(r["ms"], n=4) for name, r in res.items()}
    ratios = [b / a for a, b in zip(res["greedy_decode"]["ms"],
                                    res["greedy_decode_per_token"]["ms"])]
    rq = statistics.quantiles(ratios, n=4)
    print(f"[front] serve_step, {B} prompts x {PROMPT_LEN} tokens, {steps} steps, dense: "
          f"{sum(fused[i] == loop[i] for i in range(B))}/{B} rows equal; every token of both "
          f"vs a teacher-forced forward: {sum(d for d, _ in tf)} of {2 * B * steps} differ, "
          f"largest gap {max(g for _, g in tf):.4f} (near tie < 0.25) | launches engine "
          f"{res['greedy_decode']['counts']}, loop {res['greedy_decode_per_token']['counts']}")
    print(f"[front] serve_step wall ms per decode step over {SERVE_STEP_ROUNDS} rounds, "
          f"median [quartiles]: "
          + " | ".join(f"{name} {q[1]:.3f} [{q[0]:.3f}, {q[2]:.3f}] "
                       f"({' / '.join(f'{x:.3f}' for x in res[name]['ms'])})"
                       for name, q in quart.items())
          + f" | loop / engine within a round {rq[1]:.2f}x [{rq[0]:.2f}, {rq[2]:.2f}] "
          f"({' / '.join(f'{x:.2f}' for x in ratios)}) [{smi}]")
    print(f"[front] serve_step: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# training slice
# ---------------------------------------------------------------------------
def phase_training_kernels(gen):
    """K1, K2, K4/K5 against their plain versions at the training shapes,
    and K3 there too (its o and lse feed K4/K5). Returns the largest error
    of each."""
    import torch

    from repro_torch.kernels import pamm_apply
    from repro_torch.kernels.pamm_apply import segment_matmul_cuda, segment_matmul_ref
    from repro_torch.kernels.pamm_compress import csim_argmax_cuda, csim_argmax_ref

    b, n = TRAIN_BATCH * TRAIN_SEQ, 2048
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0}
    for k, dtype in ((16, torch.bfloat16), (16, torch.float32), (b // 8, torch.bfloat16)):
        x = _randn((b, n), gen, dtype)
        idx = torch.randperm(b, generator=gen, device="cuda")[:k]
        c = x[idx].contiguous()
        cs, f, na = csim_argmax_cuda(x, c)
        cs_r, f_r, na_r = csim_argmax_ref(x, c)
        e_cs = (cs.abs() - cs_r.abs()).abs().max().item()
        e_n = ((na - na_r).abs() / na_r).max().item()
        csim = (x.float() @ c.float().T) / (na_r[:, None] * c.float().norm(dim=1)[None])
        top2 = csim.abs().topk(2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > TOL_K1_MARGIN
        n_bad = int((f[clear] != f_r[clear]).sum())
        print(f"[K1] b={b} n={n} k={k} {str(dtype)[6:]}: max||cs|-|cs_ref||={e_cs:.3e} "
              f"max rel |norm err|={e_n:.3e} (tol {TOL_K1}); idx equal on "
              f"{int(clear.sum())}/{b} rows with a top-2 margin > {TOL_K1_MARGIN} "
              f"({n_bad} differ)")
        check(e_cs <= TOL_K1 and e_n <= TOL_K1 and n_bad == 0,
              f"K1 disagrees with its plain version at k={k} {dtype}")
        errs["K1"] = max(errs["K1"], e_cs)
    for m, splits in ((2048, None), (1024, None), (1024, 3), (1024, 17)):
        f = torch.randint(0, 16, (b,), generator=gen, device="cuda", dtype=torch.int32)
        alpha = torch.randn(b, generator=gen, device="cuda")
        gz = _randn((b, m), gen)
        with k2_split_count(splits):
            out = segment_matmul_cuda(f, alpha, gz, 16)
            again = segment_matmul_cuda(f, alpha, gz, 16)
            S = pamm_apply._splits(b, m, 16)[0]
        ref = segment_matmul_ref(f, alpha, gz, 16)
        scale = ref.abs().max().item()
        e = (out - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        print(f"[K2] b={b} m={m} k=16 bf16, {S} splits"
              f"{' (the rule)' if splits is None else ' (forced)'}: max|B-B_ref|={e:.3e} "
              f"(tol {TOL_K2} x {scale:.1f}); two launches bitwise equal: {same}")
        check(e <= TOL_K2 * scale and same,
              f"K2 disagrees or is not deterministic at m={m}, {S} splits")
        errs["K2"] = max(errs["K2"], e)
    bf16 = torch.bfloat16
    # B, L, dh, window, offs, dtype: a ring's chunk pairs get the merged lse
    # (finite on every row), as its backward does; the last case takes the
    # f32 routes
    for B, L, dh, window, offs, dtype in (
            (TRAIN_BATCH, TRAIN_SEQ, 128, 0, None, bf16),
            (TRAIN_BATCH, TRAIN_SEQ, 128, 256, None, bf16),
            (TRAIN_BATCH, TRAIN_SEQ, 80, 0, None, bf16),
            (TRAIN_BATCH, TRAIN_SEQ, 120, 0, None, bf16),
            (TRAIN_BATCH, TRAIN_SEQ, 128, 0, (TRAIN_SEQ, 0), bf16),
            (TRAIN_BATCH, TRAIN_SEQ, 128, 256, (2 * TRAIN_SEQ, TRAIN_SEQ), bf16),
            (2, 1100, 128, 0, None, torch.float32)):
        check_k3_k45(gen, B, L, 16, 8, dh, window, offs, dtype, errs,
                     repeat=(dh, window, offs, dtype) == (128, 0, None, bf16))
    torch.cuda.empty_cache()
    return errs


def check_k3_k45(gen, B, L, H, KV, dh, window, offs, dtype, errs, *, repeat: bool = False):
    """K3 and then K4/K5 (fed K3's o and lse) against their plain versions
    at one training shape, each gradient to its largest magnitude and per
    row; ``repeat``: two launches of K4/K5 bitwise equal. The bf16 routes'
    largest errors go into ``errs``."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_fwd_cuda)

    bf16 = torch.bfloat16
    q = _randn((B, L, H, dh), gen, dtype)
    k, v = _randn((B, L, KV, dh), gen, dtype), _randn((B, L, KV, dh), gen, dtype)
    do = _randn((B, L, H, dh), gen, dtype)
    e_o, o, lse = check_k3(q, k, v, window=window, offs=offs, label=", training shape")
    if dtype == bf16:
        errs["K3"] = max(errs["K3"], e_o)
    fwd = (o, lse)
    if offs is not None:
        lse = torch.logaddexp(lse, torch.rand(lse.shape, generator=gen, device="cuda"))
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=window,
                                   offs=offs)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=window,
                                  offs=offs)
    tol, tol_row = (TOL_K45, TOL_ROW) if dtype == bf16 else (TOL_K45_F32, TOL_ROW_F32)
    parts = []
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        scale = r.float().abs().max().item()
        e = (a.float() - r.float()).abs().max().item()
        e_r = row_err(a, r)
        parts.append(f"{name} {e:.3e} of {scale:.2f}, row rel {e_r:.3e}")
        check(bool(a.isfinite().all()) and e <= tol * scale and e_r <= tol_row,
              f"K4/K5 {name} disagrees with the plain version at "
              f"{(B, L, H, KV, dh, window, offs)} {dtype}")
        if dtype == bf16:
            kk = "K4" if name == "dq" else "K5"
            errs[kk] = max(errs[kk], e)
    same = ""
    if repeat:
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=window)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "two launches of the bf16 K4/K5 give other bits")
        again = flash_attention_fwd_cuda(q, k, v, causal=True, window=window, offs=offs)
        check(all(torch.equal(a, b) for a, b in zip(fwd, again)),
              "two launches of the bf16 K3 give other bits")
        same = "; two launches of K3 and of K4/K5 bitwise equal"
        del again
    route = "tensor cores" if dtype == bf16 else "f32 route"
    print(f"[K4/K5] B={B} L={L} H={H} KV={KV} dh={dh} window={window} offs={offs} "
          f"{str(dtype)[6:]} ({route}): max |d-d_ref| {'; '.join(parts)} (tol {tol} x max, "
          f"row {tol_row}){same}")


class NumpySampler:
    """Generator rows and projections from numpy, seeded by a hash of the
    key path: the same draws on the card and on the CPU."""

    @staticmethod
    def _rng(seed, path):
        import numpy as np

        h = hashlib.blake2b(repr((seed, path)).encode(), digest_size=8).digest()
        return np.random.default_rng(int.from_bytes(h, "little"))

    def choice(self, seed, path, b, k, device):
        import torch

        return torch.from_numpy(self._rng(seed, path).permutation(b)[:k]).to(device)

    def normal(self, seed, path, shape, device):
        import numpy as np
        import torch

        return torch.from_numpy(self._rng(seed, path).standard_normal(
            shape, dtype=np.float32)).to(device)


def phase_card_vs_cpu(arch="internlm2-1.8b_smoke", spec="attn.qkv=pamm(r=1/8)",
                      want_launches: dict | None = None, batch: int = 4):
    """One train step of ``arch`` (a smoke arch) in f32 under ``spec`` over
    ``batch`` rows of 64 tokens: the card (kernels) against the CPU (plain
    versions), same parameters and draws; ``want_launches``: the card's
    launch counts of one loss and backward, where the caller derives
    them."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.keys import Key
    from repro_torch.core.plan import resolve_for_run
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import launches
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, loss_and_grad, make_train_step
    from repro_torch.train.train_step import batch_to_device

    cfg = get_config(arch)
    rcfg = RunConfig(compression=spec, policy_name="none",
                     compute_dtype="float32", param_dtype="float32")
    cpu = init_model(cfg, rcfg, seed=0, device="cpu")
    if cfg.vision_tokens:
        print(f"[card vs cpu] {arch}: gate_attn and gate_ffn of {set_gates(cpu)} xattn "
              f"layers filled with {VIS_GATE} (zero at init: the block is the identity)")
    card = copy.deepcopy(cpu).to("cuda")
    rows, batch = batch, SyntheticStream.for_arch(cfg, 64, batch).get_batch(0)
    resolved = resolve_for_run(cfg, rcfg)
    key = Key(rcfg.seed, sampler=NumpySampler()).fold_in(3)
    out = {}
    for name, model in (("card", card), ("cpu", cpu)):
        launches.reset()
        loss, _, grads = loss_and_grad(cfg, rcfg, resolved, model,
                                       batch_to_device(batch, model.device), key)
        out[name] = (float(loss), {n: g.cpu() for n, g in grads.items()}, launches.counts())
    (l_card, g_card, c_card), (l_cpu, g_cpu, c_cpu) = out["card"], out["cpu"]
    rel_l = abs(l_card - l_cpu) / abs(l_cpu)
    rel_g = max(((g_card[n] - g_cpu[n]).norm() / g_cpu[n].norm().clamp_min(1e-30)).item()
                for n in g_cpu)
    print(f"[card vs cpu] {arch} f32 {spec}, {rows} x 64: loss {l_card:.7f} vs "
          f"{l_cpu:.7f} (rel {rel_l:.2e}, tol {TOL_CPU_LOSS}); worst gradient rel "
          f"{rel_g:.2e} (tol {TOL_CPU_GRAD}) | card launches {c_card} | cpu {c_cpu}")
    check(rel_l <= TOL_CPU_LOSS and rel_g <= TOL_CPU_GRAD,
          "the card's train step disagrees with the CPU's")
    check(not any(k.endswith("_ref") for k in c_card) and
          all(k.endswith("_ref") for k in c_cpu), "a path took the wrong kernels")
    check(want_launches is None
          or {k: c_card.get(k, 0) for k in want_launches} == want_launches,
          f"card launches {c_card} != {want_launches}")
    step_fn = make_train_step(cfg, rcfg, total_steps=10, sampler=NumpySampler())
    zero_init = {n for n, p in cpu.named_parameters() if not p.detach().any()}
    res = {}
    for name, model in (("card", card), ("cpu", cpu)):
        st = TrainState(model, adamw_init(dict(model.named_parameters())))
        st, m = step_fn(st, batch, 3)
        res[name] = (float(m["loss"]), float(m["lr"]),
                     {n: p.detach().cpu() for n, p in model.named_parameters()})
    (l_card, _, p_card), (l_cpu, lr, p_cpu) = res["card"], res["cpu"]
    rel_l = abs(l_card - l_cpu) / abs(l_cpu)
    rel_p = max(((p_card[n] - p_cpu[n]).norm() / p_cpu[n].norm()).item()
                for n in p_cpu if n not in zero_init)
    print(f"[card vs cpu] make_train_step at step 3: loss rel {rel_l:.2e}; updated "
          f"parameters worst rel {rel_p:.2e} (tol {TOL_CPU_GRAD})")
    check(rel_l <= TOL_CPU_LOSS and rel_p <= TOL_CPU_GRAD,
          "the card's train step disagrees with the CPU's")
    check_zero_init_leaves(rcfg, zero_init, lr, g_card, g_cpu, p_card, p_cpu)


def check_zero_init_leaves(rcfg, names, lr, g_card, g_cpu, p_card, p_cpu):
    """A leaf that starts at zero (the norm scales) holds only the first
    Adam step lr * g / (|g| + eps) of the step's clipped gradient g (the
    step at ``p_*`` takes the batch and key of the gradients ``g_*``): held
    to 1e-2 * lr per element, card against CPU. Where the CPU's clipped |g|
    is under NEAR_EPS Adam eps, that step turns rounding of g into an O(1)
    change, so there the card's gradient is held to the CPU's within
    TOL_CPU_GRAD x the leaf's RMS gradient, and the card's step to the
    step that adamw_update takes from the card's own gradient, within
    1e-2 * lr."""
    import torch

    from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

    near_eps = 100
    gk, _ = clip_by_global_norm({n: g.clone() for n, g in g_card.items()}, rcfg.grad_clip)
    gc, _ = clip_by_global_norm({n: g.clone() for n, g in g_cpu.items()}, rcfg.grad_clip)
    own = {n: torch.zeros_like(gk[n]) for n in names}
    adamw_update({n: gk[n] for n in names}, adamw_init(own), own, lr,
                 weight_decay=rcfg.weight_decay, pamm_lr_scale=rcfg.pamm_lr_scale)
    far_d = near_d = near_g = 0.0
    n_near = 0
    for n in names:
        near = gc[n].abs() < near_eps * ADAM_EPS
        n_near += int(near.sum())
        d = (p_card[n] - p_cpu[n]).abs()
        far_d = max(far_d, float(d[~near].max()) if (~near).any() else 0.0)
        if near.any():
            rms = float(gc[n].norm()) / gc[n].numel() ** 0.5
            near_g = max(near_g, float((gk[n] - gc[n])[near].abs().max()) / (TOL_CPU_GRAD * rms))
            near_d = max(near_d, float((p_card[n] - own[n])[near].abs().max()))
    print(f"[card vs cpu] zero-initialised leaves: worst |update diff| {far_d:.2e} (tol 1e-2 x "
          f"lr = {1e-2 * lr:.2e}); at the {n_near} elements whose clipped CPU |g| is under "
          f"{near_eps} eps: worst |g_card - g_cpu| {near_g:.3f} of {TOL_CPU_GRAD} x the leaf's "
          f"RMS gradient, worst |card update - Adam step of the card's gradient| "
          f"{near_d:.2e} (tol {1e-2 * lr:.2e})")
    check(far_d <= 1e-2 * lr and near_g <= 1.0 and near_d <= 1e-2 * lr,
          "the card's train step disagrees with the CPU's at a zero-initialised leaf")


def _train_run(cfg, rcfg, n_steps: int, *, measure: bool, seq: int = TRAIN_SEQ):
    """init_train_state + make_train_step on the card at TRAIN_BATCH x
    ``seq``: step 0 is the warm-up; with ``measure`` the launch counts are
    set to 0 just before steps 1..n_steps and read just after. A vision
    arch's gates are filled with VIS_GATE. Returns (state, step_fn,
    record)."""
    import torch

    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import launches
    from repro_torch.train import init_train_state, make_train_step

    stream = SyntheticStream.for_arch(cfg, seq, TRAIN_BATCH, seed=rcfg.seed)
    batches = [stream.get_batch(s) for s in range(n_steps + 1)]
    state = init_train_state(cfg, rcfg, device="cuda")
    if cfg.vision_tokens:
        set_gates(state.params)
    step_fn = make_train_step(cfg, rcfg, total_steps=100)
    rec = {"loss": [], "gnorm": [], "ms": [], "gc_ms": []}
    gc_s = [0.0, 0.0]   # seconds in the host's garbage collector; its last start

    def on_gc(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    gc.callbacks.append(on_gc)
    try:
        for s in range(n_steps + 1):
            if s == 1 and measure:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                launches.reset()
            t0, gc0 = time.perf_counter(), gc_s[0]
            state, m = step_fn(state, batches[s], s)
            rec["loss"].append(float(m["loss"]))   # waits for the step
            rec["gnorm"].append(float(m["grad_norm"]))
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            rec["gc_ms"].append(1e3 * (gc_s[0] - gc0))
            if s == n_steps and measure:
                torch.cuda.synchronize()
                rec["counts"] = launches.counts()
                rec["peak"] = torch.cuda.max_memory_allocated()
                rec["metrics"] = {k: float(v) for k, v in m.items()}
    finally:
        gc.callbacks.remove(on_gc)
    return state, step_fn, rec


def phase_training(smi):
    """The training slice at full width and depth (see the module
    docstring). Returns the per-step launch counts and the record."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.plan import resolve_for_run
    from repro_torch.core.stats import plan_activation_report
    from repro_torch.data import SyntheticStream
    from repro_torch.train import make_train_step

    cfg = get_config(ARCH)
    rcfg = RunConfig(compression=TRAIN_SPEC, policy_name="none")
    tag = f"[{smi}]"
    n = TRAIN_STEPS
    state, step_fn, rec = _train_run(cfg, rcfg, n, measure=True)
    n_params = sum(p.numel() for p in state.params.parameters())
    per_step = {k: v / n for k, v in rec["counts"].items()}
    print(f"[train] {ARCH}: {n_params / 1e9:.3f} B params f32, compute {rcfg.compute_dtype}, "
          f"{TRAIN_SPEC}, batch {TRAIN_BATCH} x {TRAIN_SEQ}; losses {rec['loss']} | grad "
          f"norms {[round(g, 4) for g in rec['gnorm']]}")
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
          "a training loss or grad norm is not finite")
    print(f"[train] launches per step {per_step}")
    want = {"csim_argmax": 24, "segment_matmul": 72, "flash_attention_fwd": 24,
            "flash_attention_dq": 24, "flash_attention_dkv": 24, "flash_attention_fwd_f32": 0,
            "flash_attention_dq_f32": 0, "flash_attention_dkv_f32": 0}
    check({k: per_step.get(k, 0) for k in want} == want,
          f"training launches per step {per_step} != {want}")
    check(not any(k.endswith("_ref") for k in rec["counts"]),
          "a plain version ran on the training path")
    step_ms = statistics.median(rec["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {1e3 * tokens / step_ms:.1f} tokens/s | {step_ms:.1f} ms per step "
          f"(median of {n}; warm-up step {rec['ms'][0]:.1f} ms) | peak "
          f"torch.cuda.max_memory_allocated {rec['peak'] / 2**30:.3f} GiB {tag}")
    sites = {k: round(v, 6) for k, v in rec["metrics"].items() if k.startswith("site/")}
    print(f"[train] site telemetry (summed over {cfg.n_layers} layers) {sites}")
    trace_training_step(state, step_fn, cfg, step_ms, n + 1)
    del state, step_fn
    torch.cuda.empty_cache()

    state, _, rec2 = _train_run(cfg, rcfg, n, measure=False)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec2["loss"], rec["loss"])]
    print(f"[train] second run from seed {rcfg.seed}: losses {rec2['loss']} (step 0 equal: "
          f"{rec2['loss'][0] == rec['loss'][0]}; later steps worst rel {max(rel[1:]):.2e}, "
          f"tol 1e-3 for a backward that sums in another order from run to run)")
    check(rec2["loss"][0] == rec["loss"][0] and max(rel[1:]) <= 1e-3,
          "a second run from the seed gives other losses")

    peaks = {}
    batch = SyntheticStream.for_arch(cfg, TRAIN_SEQ, TRAIN_BATCH).get_batch(n + 1)
    for label, spec in (("none", "attn.qkv=none"), ("pamm", TRAIN_SPEC)):
        fn = make_train_step(cfg, dataclasses.replace(rcfg, compression=spec),
                             total_steps=100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m = fn(state, batch, n + 1)
        float(m["loss"])
        peaks[label] = torch.cuda.max_memory_allocated()
    (report,) = plan_activation_report(resolve_for_run(cfg, rcfg), batch=TRAIN_BATCH,
                                       seq=TRAIN_SEQ)
    print(f"[train] peak of one step: attn.qkv=none {peaks['none'] / 2**30:.3f} GiB, "
          f"{TRAIN_SPEC} {peaks['pamm'] / 2**30:.3f} GiB, difference "
          f"{(peaks['none'] - peaks['pamm']) / 2**20:.1f} MiB; plan_activation_report's "
          f"QKV-input bytes ({cfg.n_layers} x {tokens} x {cfg.d_model} x 2 B) "
          f"{report.baseline_bytes / 2**20:.1f} "
          f"MiB {tag}")
    del state
    torch.cuda.empty_cache()
    rec["peak_none"], rec["peak_pamm_step"] = peaks["none"], peaks["pamm"]
    return per_step, rec


def _mode_launches(label, counts, n_steps):
    per_step = {k: v / n_steps for k, v in counts.items()}
    k1, k2, k3, k4, k5 = MODE_LAUNCHES[label]
    want = {"csim_argmax": k1, "segment_matmul": k2, "flash_attention_fwd": k3,
            "flash_attention_dq": k4, "flash_attention_dkv": k5, "flash_attention_fwd_f32": 0,
            "flash_attention_dq_f32": 0, "flash_attention_dkv_f32": 0}
    check({k: per_step.get(k, 0) for k in want} == want,
          f"{label}: launches per step {per_step} != {want}")
    check(not any(k.endswith("_ref") for k in counts), f"{label}: a plain version ran")
    return {k: v for k, v in per_step.items() if v}


def _fwd_bwd_peak(cfg, rcfg, state, seq) -> int:
    """Peak memory of one loss_and_grad (forward, backward, the grads) on
    a trained state, its AdamW moments resident: the part of a step the
    memory modes change, without the optimizer's update."""
    import torch

    from repro_torch.core.keys import Key
    from repro_torch.core.plan import resolve_for_run
    from repro_torch.data import SyntheticStream
    from repro_torch.train import loss_and_grad
    from repro_torch.train.train_step import batch_to_device

    batch = batch_to_device(SyntheticStream.for_arch(cfg, seq, TRAIN_BATCH).get_batch(99),
                            state.params.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_and_grad(cfg, rcfg, resolve_for_run(cfg, rcfg), state.params, batch,
                  Key(rcfg.seed))
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase_memory_modes(smi, rec_none):
    """The training cell under remat='full', remat='pamm' and reversible
    blocks, then 4 x LONG_SEQ under 'pamm' and reversible (see the module
    docstring). Returns {(label, seq): (step peak bytes, forward +
    backward peak bytes, ms per step, launches per step)}."""
    import math

    import torch

    from repro_torch.configs import RunConfig, get_config

    cfg = get_config(ARCH)
    tag = f"[{smi}]"
    t_phase = time.perf_counter()
    none_ms = statistics.median(rec_none["ms"][1:])
    rcfg = RunConfig(compression=TRAIN_SPEC, policy_name="none")
    state, _, _ = _train_run(cfg, rcfg, 0, measure=False)
    none_fb = _fwd_bwd_peak(cfg, rcfg, state, TRAIN_SEQ)
    del state
    print(f"[modes] remat='none' (phase 11): step peak {rec_none['peak'] / 2**30:.3f} GiB, "
          f"forward + backward peak {none_fb / 2**30:.3f} GiB, {none_ms:.1f} ms per step, "
          f"step-0 loss {rec_none['loss'][0]!r}")
    out = {}
    for seq, labels, n in ((TRAIN_SEQ, ("full", "pamm", "reversible"), MODE_STEPS),
                           (LONG_SEQ, ("pamm", "reversible"), 1)):
        for label in labels:
            rcfg = RunConfig(compression=TRAIN_SPEC, policy_name="none", **MODE_RCFG[label])
            torch.cuda.empty_cache()
            state, _, rec = _train_run(cfg, rcfg, n, measure=True, seq=seq)
            fb = _fwd_bwd_peak(cfg, rcfg, state, seq)
            del state
            torch.cuda.empty_cache()
            check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
                  f"{label} at {TRAIN_BATCH} x {seq}: a loss or grad norm is not finite")
            per_step = _mode_launches(label, rec["counts"], n)
            ms = statistics.median(rec["ms"][1:])
            line = (f"[modes] {label}, {TRAIN_BATCH} x {seq}: peak torch.cuda."
                    f"max_memory_allocated {rec['peak'] / 2**30:.3f} GiB a step, "
                    f"{fb / 2**30:.3f} GiB in forward + backward | {ms:.1f} ms per step "
                    f"(median of {[round(t, 1) for t in rec['ms'][1:]]}, of which in the "
                    f"host's garbage collector {[round(t, 1) for t in rec['gc_ms'][1:]]}; "
                    f"warm-up {rec['ms'][0]:.1f}) | "
                    f"{1e3 * TRAIN_BATCH * seq / ms:.1f} tokens/s | losses {rec['loss']}")
            if seq == TRAIN_SEQ:
                line += (f" | {rec['peak'] / rec_none['peak']:.3f}x none's step peak, "
                         f"{fb / none_fb:.3f}x its forward + backward peak, "
                         f"{ms / none_ms:.3f}x its ms")
            print(f"{line} | launches per step {per_step} {tag}")
            if seq == TRAIN_SEQ and label in ("full", "pamm"):
                a, b = rec["loss"][0], rec_none["loss"][0]
                rel = abs(a - b) / abs(b)
                print(f"[modes] {label}: step-0 loss {a!r} vs remat='none' {b!r}: "
                      f"{'bitwise equal' if a == b else f'rel {rel:.2e}'} (tol 1e-6)")
                check(rel <= 1e-6, f"{label}: the step-0 loss differs from remat='none'")
            out[label, seq] = (rec["peak"], fb, ms, per_step)
    print(f"[modes] remat='none' at {TRAIN_BATCH} x {LONG_SEQ} is not run: by the 4 x "
          f"{TRAIN_SEQ} breakdown (PERF.md) its activations are about 4 x 27 GiB next to "
          f"28 GiB of parameters, grads and moments, beyond 80 GB")
    print(f"[modes] phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_reversible_card_vs_cpu(arch="internlm2-1.8b_smoke", spec="attn.qkv=pamm(r=1/8)"):
    """Reversible blocks on ``arch`` (a smoke arch) in f32 under ``spec``,
    same parameters and draws: the card (kernels) against the CPU (plain
    versions), and reversible against reversible_ref on the card; then the
    bf16 drift of reversible against reversible_ref, printed, not held
    (the compensated bf16 pair has 16 bits: PERF.md)."""
    import dataclasses

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.keys import Key
    from repro_torch.core.plan import resolve_for_run
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import launches
    from repro_torch.models import init_model
    from repro_torch.train import loss_and_grad
    from repro_torch.train.train_step import batch_to_device

    cfg = get_config(arch)
    rcfg = RunConfig(compression=spec, policy_name="none",
                     compute_dtype="float32", param_dtype="float32",
                     block_structure="reversible")
    cpu = init_model(cfg, rcfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = SyntheticStream.for_arch(cfg, 64, 4).get_batch(0)
    key = Key(rcfg.seed, sampler=NumpySampler()).fold_in(3)

    def run(model, r):
        launches.reset()
        loss, _, grads = loss_and_grad(cfg, r, resolve_for_run(cfg, r), model,
                                       batch_to_device(batch, model.device), key)
        return float(loss), {n: g.cpu() for n, g in grads.items()}, launches.counts()

    def worst(g, ref, per_leaf_max: bool):
        if per_leaf_max:
            return max(((g[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30))
                       .item() for n in ref)
        return max(((g[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item()
                   for n in ref)

    (l_card, g_card, c_card), (l_cpu, g_cpu, c_cpu) = run(card, rcfg), run(cpu, rcfg)
    rel_l, rel_g = abs(l_card - l_cpu) / abs(l_cpu), worst(g_card, g_cpu, False)
    print(f"[rev card vs cpu] {arch} f32 reversible {spec}: loss {l_card:.7f} vs "
          f"{l_cpu:.7f} (rel {rel_l:.2e}, tol {TOL_CPU_LOSS}); worst gradient rel "
          f"{rel_g:.2e} (tol {TOL_CPU_GRAD}) | card launches {c_card} | cpu {c_cpu}")
    check(rel_l <= TOL_CPU_LOSS and rel_g <= TOL_CPU_GRAD,
          "reversible: the card's gradients disagree with the CPU's")
    check(not any(k.endswith("_ref") for k in c_card) and
          all(k.endswith("_ref") for k in c_cpu), "a reversible path took the wrong kernels")
    ref = dataclasses.replace(rcfg, block_structure="reversible_ref")
    l_ref, g_ref, c_ref = run(card, ref)
    rel_l, rel_g = abs(l_card - l_ref) / abs(l_ref), worst(g_card, g_ref, True)
    print(f"[rev card vs cpu] on the card, reversible vs reversible_ref (f32): loss rel "
          f"{rel_l:.2e} (tol 1e-6), worst gradient max|diff|/max|ref| {rel_g:.2e} (tol "
          f"{TOL_REV}) | launches reversible {c_card} | reversible_ref {c_ref}")
    check(rel_l <= 1e-6 and rel_g <= TOL_REV, "reversible disagrees with reversible_ref")
    bf = {s: dataclasses.replace(rcfg, compute_dtype="bfloat16", block_structure=s)
          for s in ("reversible", "reversible_ref")}
    (l_a, g_a, _), (l_b, g_b, _) = run(card, bf["reversible"]), run(card, bf["reversible_ref"])
    print(f"[rev card vs cpu] bf16 compute on the card, reversible vs reversible_ref: loss "
          f"{l_a!r} vs {l_b!r}; worst gradient max|diff|/max|ref| {worst(g_a, g_b, True):.3e} "
          f"(not held: the bf16 pair rebuilds the streams to 16 bits only)")


def phase_supervised_restart(smi):
    """run_supervised over 6 steps of internlm2-1.8b_smoke on the card
    (bf16 compute, f32 parameters; the smoke arch keeps the checkpoint
    small), a checkpoint every 2 steps and a fault injected at step 3,
    against an uninterrupted run; then the save and load of its state
    timed. Checkpoints go under build/ and are removed."""
    import math

    import torch

    from repro_torch import bridge
    from repro_torch.checkpoint import load, save
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.runtime.fault import FaultInjector, StragglerWatchdog, run_supervised
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config("internlm2-1.8b_smoke")
    rcfg = RunConfig(compression="attn.qkv=pamm(r=1/8)", policy_name="none")
    steps, seq = 6, 256
    stream = SyntheticStream.for_arch(cfg, seq, TRAIN_BATCH, seed=rcfg.seed)
    step_fn = make_train_step(cfg, rcfg, total_steps=steps)
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        plain = init_train_state(cfg, rcfg, device="cuda")
        want = []
        for s in range(steps):
            plain, m = step_fn(plain, stream.get_batch(s), s)
            want.append(float(m["loss"]))
        holder = {"state": init_train_state(cfg, rcfg, device="cuda")}
        got: dict[int, float] = {}
        runs = []

        def one_step(s):
            holder["state"], m = step_fn(holder["state"], stream.get_batch(s), s)
            got[s] = float(m["loss"])
            runs.append(s)
            return {}

        report = run_supervised(
            total_steps=steps, step_fn=one_step,
            state_provider=lambda: bridge.train_state_tree(holder["state"]),
            state_restorer=lambda tree, s: holder.__setitem__(
                "state", bridge.install_train_state_tree(holder["state"], tree)),
            ckpt_root=str(root / "run"), ckpt_every=2, watchdog=StragglerWatchdog(),
            injector=FaultInjector(fail_at=(3,)))
        rel = [abs(got[s] - want[s]) / abs(want[s]) for s in range(steps)]
        print(f"[restart] internlm2-1.8b_smoke, {TRAIN_BATCH} x {seq}, bf16 compute: "
              f"{report}; steps run {runs}; losses {[got[s] for s in range(steps)]} vs "
              f"uninterrupted {want}: worst rel {max(rel):.2e} (tol {TOL_RESTART})")
        check(report.restarts == 1 and report.completed_steps == steps,
              f"the supervisor did not recover: {report}")
        check(all(math.isfinite(x) for x in want) and max(rel) <= TOL_RESTART,
              "the restored run's losses differ from the uninterrupted run's")
        tree = bridge.train_state_tree(holder["state"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = Path(save(str(root / "timed"), steps, tree))
        t1 = time.perf_counter()
        loaded, _ = load(str(root / "timed"), tree)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nbytes = sum(f.stat().st_size for f in path.iterdir())
        check(torch.equal(loaded.params["embed"], tree.params["embed"]),
              "a loaded checkpoint differs from the saved state")
        print(f"[restart] checkpoint of the train state (parameters and AdamW moments, "
              f"{nbytes} bytes written): save {1e3 * (t1 - t0):.1f} ms, load with CRC "
              f"{1e3 * (t2 - t1):.1f} ms [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def trace_training_step(state, step_fn, cfg, step_ms, step, tag=""):
    """torch.profiler split of one training step by kernel group, and the
    device's idle share against the unprofiled step time. K1 and K2 count
    their 2-D and batched (moe.expert) launches together: both run the same
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticStream

    batch = SyntheticStream.for_arch(cfg, TRAIN_SEQ, TRAIN_BATCH).get_batch(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, step)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # symbols of both routes: dq_kernel(_mma), dkv_kernel(_mma), fwd_kernel_f32 / _mma
    names = (("csim_argmax", "K1"), ("segment_matmul", "K2"), ("dkv_kernel", "K5"),
             ("dq_kernel", "K4"), ("fwd_kernel", "K3"))
    groups: dict[str, float] = {}
    others: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type != DeviceType.CUDA or us <= 0:
            continue
        name = evt.key
        group = next((g for s, g in names if s in name), None)
        if group is None:
            group = "GEMM" if any(s in name.lower() for s in GEMM_NAMES) else "other"
        groups[group] = groups.get(group, 0.0) + us / 1e3
        if group == "other":
            others[name] = others.get(name, 0.0) + us / 1e3
    busy = sum(groups.values())
    if busy == 0:
        print(f"[trace] {tag}train step: device time not measured (the profiler recorded no "
              f"device activity); wall {wall_ms:.1f} ms")
        return
    parts = " | ".join(f"{g} {ms:.2f} ms" for g, ms in
                       sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"[trace] {tag}train step: device busy {busy:.1f} ms of {step_ms:.1f} ms unprofiled "
          f"wall ({100 * busy / step_ms:.1f}% busy, {100 - 100 * busy / step_ms:.1f}% idle; "
          f"{wall_ms:.1f} ms under the profiler) | {parts}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    print(f"[trace] {tag}train step: largest other kernels: "
          + " | ".join(f"{ms:.2f} ms {name[:60]}" for name, ms in top))
    # the same device time by the PyTorch op that launched it
    ops = sorted(((getattr(e, "self_device_time_total", 0) or 0, e.count, e.key)
                  for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 reverse=True)[:8]
    print(f"[trace] {tag}train step: device time by launching op: "
          + " | ".join(f"{key} {us / 1e3:.2f} ms ({n} calls)" for us, n, key in ops))


def phase_training_numbers(gen, per_step, rec, smi, errs):
    """Kernel rows of K1, K2, K4 and K5 at the training shapes (and K3's
    time there), next to the plain versions, the SDPA backward and the
    bound."""
    import torch

    from repro_torch.kernels.pamm_apply import segment_matmul_cuda, segment_matmul_ref
    from repro_torch.kernels.pamm_compress import csim_argmax_cuda, csim_argmax_ref

    tag = f"[{smi}]"
    launches = {k: int(round(v * TRAIN_STEPS)) for k, v in per_step.items()}
    b, n, k = TRAIN_BATCH * TRAIN_SEQ, 2048, 16
    x = _randn((b, n), gen)
    c = x[torch.randperm(b, generator=gen, device="cuda")[:k]].contiguous()
    flush = _flush_buffer()
    k1 = _kernel_row("csim_argmax (K1, bf16 tensor-core route)", K1_SOURCE, K1_REPLACES,
                     launches.get("csim_argmax", 0), errs["K1"],
                     lambda: csim_argmax_cuda(x, c), lambda: csim_argmax_ref(x, c), None,
                     k1_work(b, n, k, 2))
    # the nearest single PyTorch calls (side numbers, not the library column:
    # neither computes the kernel's function)
    side = {"K1": ("torch.mm(x, c.T), the dots alone",
                   time_ms(lambda: torch.mm(x, c.T), flush=flush))}
    f = torch.randint(0, k, (b,), generator=gen, device="cuda", dtype=torch.int32)
    alpha = torch.randn(b, generator=gen, device="cuda")
    fl = f.long()
    k2 = {}
    for m in (2048, 1024):
        gz = _randn((b, m), gen)
        k2[m] = _kernel_row("segment_matmul (K2, split over the rows)", K2_SOURCE, K2_REPLACES,
                            launches.get("segment_matmul", 0), errs["K2"],
                            lambda: segment_matmul_cuda(f, alpha, gz, k),
                            lambda: segment_matmul_ref(f, alpha, gz, k), None,
                            k2_work(b, m, k, 2))
        bprime = alpha[:, None] * gz.float()
        side[f"K2 m{m}"] = (
            "index_add_ of prescaled f32 alpha*dZ (atomics, not deterministic)",
            time_ms(lambda: torch.zeros((k, m), device="cuda").index_add_(0, fl, bprime),
                    flush=flush))
        del bprime
    rows = [k1, k2[2048]]
    for row, key in ((k1, "K1"), (k2[2048], "K2 m2048"), (k2[1024], "K2 m1024")):
        label, side_ms = side[key]
        at = f" at m={key[4:]}" if key.startswith("K2") else f" at ({b}, {n}, k {k})"
        print(f"[numbers] {row['name']}{at}: {row['ms']:.4f} ms/call{timing_note(row, key)} | "
              f"plain {row['plain_ms']:.4f} ms | side: {label} {side_ms:.4f} ms | library n/a | "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) | {row['launches']} launches "
              f"on the training path ({TRAIN_STEPS} steps) {tag}")
    B, L, H, KV, dh = TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128
    att = attention_inputs(gen, B, L, H, KV, dh)
    k4 = _kernel_row("flash_attention_dq (K4, bf16 tensor-core route)", K45_SOURCE, K4_REPLACES,
                     launches.get("flash_attention_dq", 0), errs["K4"], *att["K4"])
    k5 = _kernel_row("flash_attention_dkv (K5, bf16 tensor-core route)", K45_SOURCE, K5_REPLACES,
                     launches.get("flash_attention_dkv", 0), errs["K5"], *att["K5"])
    rows += [k4, k5]
    k3_fn, k3_plain_fn, k3_sdpa_fn, k3_w = att["K3"]
    k3 = {"ms": time_ms(k3_fn, flush=flush), "device_ms": time_ms(k3_fn, flush=flush, pad=True),
          "host_ms": host_ms(k3_fn)}
    k3_plain = time_ms(k3_plain_fn, reps=10, flush=flush)
    k3_sdpa = time_ms(k3_sdpa_fn, flush=flush)
    k3_bound, k3_by = bound(*k3_w)
    for row, key in ((k4, "K4"), (k5, "K5")):
        print(f"[numbers] {row['name']}: {row['ms']:.4f} ms/call{timing_note(row, key)} | "
              f"plain {row['plain_ms']:.4f} ms | library {row['library_ms']:.4f} ms | bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | {row['launches']} launches on "
              f"the training path ({TRAIN_STEPS} steps) {tag}")
    print(f"[numbers] flash_attention_fwd (K3, bf16 tensor-core route) at the training shape "
          f"({B}, {L}, {H}/{KV}, {dh}): {k3['ms']:.4f} ms/call"
          f"{timing_note(k3, 'K3 training')} | plain "
          f"{k3_plain:.4f} ms | SDPA {k3_sdpa:.4f} ms | "
          f"bound {k3_bound:.4f} ms ({k3_by}) | max|o-o_ref| {errs['K3']:.3e} at the "
          f"training shapes | {per_step.get('flash_attention_fwd', 0):.0f} "
          f"launches per training step {tag}")
    step_ms = statistics.median(rec["ms"][1:])
    k2_step = 24 * k2[2048]["ms"] + 48 * k2[1024]["ms"]
    print(f"[numbers] train step {step_ms:.1f} ms: K1 x24 {24 * k1['ms']:.2f} ms, K2 x72 "
          f"{k2_step:.2f} ms (24 at m=2048, 48 at m=1024), K3 x24 {24 * k3['ms']:.1f} ms, K4 x24 "
          f"{24 * k4['ms']:.1f} ms, K5 x24 {24 * k5['ms']:.1f} ms (isolated, L2 flushed) {tag}")
    return rows


# ---------------------------------------------------------------------------
# the MoE slice: granite-moe-3b-a800m
# ---------------------------------------------------------------------------
def moe_site_inputs(gen, E, b, n, k, dtype=None):
    """x (E, b, n) as the moe.expert site sees it: expert 0 empty (all
    rows zero), the second half of expert 1's capacity zero padding; each
    expert's generator rows ``c`` (E, k, n)."""
    import torch

    x = _randn((E, b, n), gen, dtype)
    x[0] = 0
    x[1, b // 2:] = 0
    idx = torch.stack([torch.randperm(b, generator=gen, device="cuda")[:k] for _ in range(E)])
    c = x[torch.arange(E, device="cuda")[:, None], idx].contiguous()
    return x, c


def phase_moe_kernels(gen):
    """The batched K1 / K2 at the moe.expert site's shapes (E 40 x b 2048
    capacity x n 1536, k 4; K2 at m 512 at the rule's split count and at
    1, 3 and 17 forced splits; one f32-route K1 case), each against its
    plain version, two launches bitwise equal, and experts 0-2 bitwise
    equal to a 2-D launch on their own inputs; then K3-K7 at granite's G 3
    / dh 64 shapes (prefill, training with K4/K5, decode 8 x 1089, paged
    8 x 17 pages). Returns the largest errors."""
    import torch

    from repro_torch.kernels import pamm_apply
    from repro_torch.kernels.pamm_apply import (segment_matmul_batched_cuda,
                                                segment_matmul_batched_ref, segment_matmul_cuda)
    from repro_torch.kernels.pamm_compress import (csim_argmax_batched_cuda,
                                                   csim_argmax_batched_ref, csim_argmax_cuda)

    errs = {"K1b": 0.0, "K2b": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0, "K7": 0.0,
            "K8": 0.0}
    E, b, n, k, m = MOE_E, MOE_CAP, MOE_D, MOE_K, MOE_F
    for E_, b_, n_, k_, dtype in ((E, b, n, k, torch.bfloat16), (3, 1000, 200, 20, torch.float32)):
        x, c = moe_site_inputs(gen, E_, b_, n_, k_, dtype)
        out = csim_argmax_batched_cuda(x, c)
        again = csim_argmax_batched_cuda(x, c)
        same = all(torch.equal(a, a2) for a, a2 in zip(out, again))
        alone = all(torch.equal(a[e], a2) for e in range(3)
                    for a, a2 in zip(out, csim_argmax_cuda(x[e], c[e])))
        cs, f, na = out
        cs_r, f_r, na_r = csim_argmax_batched_ref(x, c)
        e_cs = (cs.abs() - cs_r.abs()).abs().max().item()
        e_n = ((na - na_r).abs() / na_r.clamp_min(1e-30)).max().item()
        csim = torch.bmm(x.float(), c.float().transpose(1, 2)) / (
            na_r.clamp_min(1e-20)[..., None] * c.float().norm(dim=2).clamp_min(1e-20)[:, None])
        top2 = csim.abs().topk(2, dim=2).values
        clear = top2[..., 0] - top2[..., 1] > TOL_K1_MARGIN
        n_bad = int((f[clear] != f_r[clear]).sum())
        empty = not (cs[0].any() or f[0].any() or na[0].any())
        print(f"[K1 batched] E={E_} b={b_} n={n_} k={k_} {str(dtype)[6:]}: "
              f"max||cs|-|cs_ref||={e_cs:.3e} max rel |norm err|={e_n:.3e} (tol {TOL_K1}); idx "
              f"equal on {int(clear.sum())}/{E_ * b_} rows with a top-2 margin > "
              f"{TOL_K1_MARGIN} ({n_bad} differ); the empty expert cs = idx = norm = 0: "
              f"{empty}; two launches bitwise equal: {same}; experts 0-2 bitwise equal to 2-D "
              f"launches: {alone}")
        check(e_cs <= TOL_K1 and e_n <= TOL_K1 and n_bad == 0 and empty and same and alone,
              f"the batched K1 disagrees with its plain version at E={E_} {dtype}")
        errs["K1b"] = max(errs["K1b"], e_cs)
    x, c = moe_site_inputs(gen, E, b, n, k)
    f = csim_argmax_batched_cuda(x, c)[1]
    alpha = torch.randn((E, b), generator=gen, device="cuda")
    alpha[0], alpha[1, b // 2:] = 0, 0                     # the padding rows
    gz = _randn((E, b, m), gen)
    ref = segment_matmul_batched_ref(f, alpha, gz, k)
    scale = ref.abs().max().item()
    for splits in (None, 1, 3, 17):
        with k2_split_count(splits):
            out = segment_matmul_batched_cuda(f, alpha, gz, k)
            again = segment_matmul_batched_cuda(f, alpha, gz, k)
            S, per = pamm_apply._splits_batched(E, b, m, k)
        real = pamm_apply._splits
        pamm_apply._splits = lambda b_, m_, k_: (S, per)   # each expert alone, same splits
        try:
            alone = all(torch.equal(out[e], segment_matmul_cuda(f[e], alpha[e], gz[e], k))
                        for e in range(3))
        finally:
            pamm_apply._splits = real
        e = (out - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        print(f"[K2 batched] E={E} b={b} m={m} k={k} bf16, {S} splits an expert"
              f"{' (the rule)' if splits is None else ' (forced)'}: max|B-B_ref|={e:.3e} (tol "
              f"{TOL_K2} x {scale:.1f}); the empty expert all zero: {not out[0].any()}; two "
              f"launches bitwise equal: {same}; experts 0-2 bitwise equal to 2-D launches at "
              f"{S} splits: {alone}")
        check(e <= TOL_K2 * scale and same and alone and not out[0].any(),
              f"the batched K2 disagrees or is not deterministic at {S} splits")
        errs["K2b"] = max(errs["K2b"], e)
    del x, c, gz
    H, KV, dh = MOE_HEADS
    bf16 = torch.bfloat16
    for B, L, dtype in ((1, PROMPT_LEN, bf16), (1, 1000, torch.float32)):
        q = _randn((B, L, H, dh), gen, dtype)
        kk, v = _randn((B, L, KV, dh), gen, dtype), _randn((B, L, KV, dh), gen, dtype)
        e, _, _ = check_k3(q, kk, v, window=0, label=", granite serving shape")
        if dtype == bf16:
            errs["K3"] = max(errs["K3"], e)
    check_k3_k45(gen, TRAIN_BATCH, TRAIN_SEQ, H, KV, dh, 0, None, bf16, errs, repeat=True)
    errs["K6"] = check_k6(gen, SLOTS, MAX_LEN, H, KV, dh, ring=False)
    for case in (("granite heads, shuffled, row 3 parked", dh, 1, False, 0, None, None, None),
                 ("granite heads, a hole, 1 split", dh, 1, True, 0, None, None, 1),
                 ("granite heads, int8 ngr 1, a hole", dh, 1, True, 0, None, (8, 1), None),
                 ("granite heads, int4 ngr 1", dh, 1, False, 0, None, (4, 1), None)):
        name, e = check_paged(gen, *case, H=H, KV=KV)
        errs[name] = max(errs[name], e)
    torch.cuda.empty_cache()
    return errs


class _DecodeMargins:
    """Wraps the engine's ``decode_step`` to keep, for each decode step, the
    top-2 logit margin of every slot, its position and the uid it serves
    (read after the run: no host sync inside it)."""

    def __init__(self, engine_mod, eng):
        self.mod, self.eng, self.real = engine_mod, eng, engine_mod.decode_step
        self.steps = []

    def __enter__(self):
        def recording(cfg, rcfg, model, tokens, pos, caches):
            logits, caches = self.real(cfg, rcfg, model, tokens, pos, caches)
            top2 = logits[:, -1, : cfg.vocab_size].topk(2, dim=-1).values
            self.steps.append((self.eng.decode_state.slot_uid.copy(), pos[:, -1].clone(),
                               top2[:, 0] - top2[:, 1]))
            return logits, caches

        self.mod.decode_step = recording
        return self

    def __exit__(self, *exc):
        self.mod.decode_step = self.real

    def margin(self, uid, pos):
        """The margin of the step that decoded ``uid`` at ``pos`` (the
        token emitted there is its generated token pos - prompt_len + 1)."""
        for uids, p, mg in self.steps:
            for slot in range(len(uids)):
                if int(uids[slot]) == uid and int(p[slot]) == pos:
                    return float(mg[slot])
        return None


def phase_moe_serving(smi):
    """granite-moe-3b-a800m served at full width, cut to 8 of its 32 layers
    (``SERVE_REPS``; see the module
    docstring). Returns what the numbers phase prints."""
    import dataclasses

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as engine_mod

    cfg = serve_cfg(MOE_ARCH)
    rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
    t0 = time.perf_counter()
    model = init_model(cfg, rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[moe serve] {MOE_ARCH}: {n_params / 1e9:.3f} B params (bf16), {cfg.n_layers} "
          f"layers, {cfg.n_experts} experts top-{cfg.n_experts_per_tok}, initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    engine = lambda layout="dense", c=cfg, compress="": ServeEngine(
        c, rcfg, model, max_slots=SLOTS, max_len=MAX_LEN, decode_block=DECODE_BLOCK,
        cache_layout=layout, page_size=PAGE, cache_compress=compress)
    n = cfg.n_layers
    tag = f"[{smi}]"
    res = {}
    warm_eng = engine()
    with _DecodeMargins(engine_mod, warm_eng) as margins:   # the warm-up run, recorded
        warm = warm_eng.run(_requests(cfg))
    for layout in ("dense", "paged"):
        torch.cuda.reset_peak_memory_stats()
        eng = engine(layout)
        out, counts = _counted(lambda: eng.run(_requests(cfg)))
        peak = torch.cuda.max_memory_allocated()
        stats = eng.stats()
        check(sorted(out) == list(range(N_REQUESTS))
              and all(len(out[u].tokens) == GEN for u in out),
              f"moe {layout}: not every request finished with {GEN} tokens")
        check(stats["nonfinite_logits"] == 0,
              f"moe {layout}: {stats['nonfinite_logits']} non-finite logits rows")
        check(stats["buckets_enabled"] is False, "moe: prefill bucketing is on")
        print(f"[moe serve] {layout} launches {counts} | prefills {stats['prefill_count']} | "
              f"decode steps {stats['decode_steps']} | buckets_enabled "
              f"{stats['buckets_enabled']}")
        want = {"flash_attention_fwd": n * stats["prefill_count"],
                "flash_decode": n * stats["decode_steps"] if layout == "dense" else 0,
                "flash_paged_decode": n * stats["decode_steps"] if layout == "paged" else 0,
                "flash_attention_fwd_f32": 0}
        check({k: counts.get(k, 0) for k in want} == want
              and not any(k.endswith("_ref") for k in counts),
              f"moe {layout}: launches {counts}, want {want} and no plain version")
        print(f"[moe serve] {layout}: decode {stats['decode_tok_s']:.1f} tok/s | p50 "
              f"{stats['p50_token_latency_ms']:.3f} / p95 {stats['p95_token_latency_ms']:.3f} "
              f"ms per step | prefill {stats['prefill_tok_s']:.1f} tok/s | peak "
              f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB {tag}")
        res[layout] = {"out": out, "counts": counts, "stats": stats, "peak": peak}
    dense, paged = res["dense"]["out"], res["paged"]["out"]
    check(all(warm[u].tokens == dense[u].tokens for u in dense),
          "moe dense: a second run gave different tokens")
    # dense against paged: a greedy stream may part only at a near tie of
    # the batched decode step's own logits (a solo prefill is no reference
    # here: expert capacity couples the slots of a step)
    reqs = {r.uid: r for r in _requests(cfg)}
    parted = []
    for u in dense:
        diff = [t for t in range(GEN) if dense[u].tokens[t] != paged[u].tokens[t]]
        if not diff:
            continue
        t = diff[0]
        mg = margins.margin(u, len(reqs[u].tokens) + t - 1) if t else None
        parted.append((u, t, mg))
        if reqs[u].sampling.temperature == 0:
            check(mg is not None and mg < 0.25,
                  f"moe paged vs dense: greedy request {u} parts at token {t} at a top-2 "
                  f"margin of {mg}, not a near tie")
    print(f"[moe serve] paged tokens equal to dense for {N_REQUESTS - len(parted)}/"
          f"{N_REQUESTS} requests; parted (uid, token, dense top-2 margin there): {parted}; "
          f"dense second run identical")
    # teacher forcing at capacity factor 16 (nothing dropped: a token's
    # output does not depend on the batch, tests/test_models_smoke.py:82-84)
    cfg16 = dataclasses.replace(cfg, capacity_factor=16.0)
    out16 = engine(c=cfg16).run(_requests(cfg16))
    greedy = [r for r in _requests(cfg16) if r.sampling.temperature == 0]
    tf = [teacher_forced(cfg16, rcfg, model, r, out16[r.uid].tokens, "moe cf 16")
          for r in greedy]
    print(f"[moe serve] capacity factor 16: every token of the {len(greedy)} greedy streams "
          f"vs a teacher-forced forward over its own tokens: {sum(d for d, _ in tf)} of "
          f"{len(greedy) * GEN} differ, their largest gap to the top logit "
          f"{max(w for _, w in tf):.4f} (near tie < 0.25)")
    moe_quant_pools(cfg16, rcfg, model, engine, out16, res, tag)
    st = res["dense"]["stats"]
    trace_breakdown(cfg, engine, model, {
        "prefill": 1e3 * st["prefill_s"] / max(1, st["prefill_count"]),
        "decode block": 1e3 * st["decode_s"] / max(1, st["decode_steps"]) * DECODE_BLOCK},
        tag="moe ")
    del model, warm_eng
    torch.cuda.empty_cache()
    return res


def moe_quant_pools(cfg16, rcfg, model, engine, out16, res, tag):
    """granite on int8 and int4 page pools (K8 at G 3, dh 64) at capacity
    factor 16, where nothing drops and a teacher-forced forward is the
    reference: the serving phase's requests, launches K8 = 32 x decode
    steps and no other decode kernel, the first spliced decode step's
    logits against the fp pool's (printed), each greedy stream against
    the fp (dense) run's, parting only at a near tie widened by the JAX
    package's logit bound of the format on both top logits, and every
    token against a teacher-forced forward at the same margin. Adds each
    format's record to ``res``."""
    import torch

    from repro_torch.serve import ServeEngine

    n = cfg16.n_layers
    probe = ServeEngine(cfg16, rcfg, model, max_slots=1, max_len=MAX_LEN, cache_layout="paged",
                        page_size=PAGE)
    prefix = probe.prefill(model, _requests(cfg16)[0])
    ref = _spliced_logits(cfg16, rcfg, model, "", prefix)
    greedy = [r for r in _requests(cfg16) if r.sampling.temperature == 0]
    for spec in ("int8", "int4"):
        torch.cuda.reset_peak_memory_stats()
        eng = engine("paged", c=cfg16, compress=spec)
        out, counts = _counted(lambda: eng.run(_requests(cfg16)))
        peak = torch.cuda.max_memory_allocated()
        st = eng.stats()
        check(sorted(out) == list(range(N_REQUESTS)) and st["nonfinite_logits"] == 0
              and all(len(out[u].tokens) == GEN for u in out),
              f"moe {spec}: a request did not finish or logits were not finite")
        want = {"flash_attention_fwd": n * st["prefill_count"],
                "flash_paged_decode_quant": n * st["decode_steps"],
                "flash_paged_decode": 0, "flash_decode": 0}
        check({k: counts.get(k, 0) for k in want} == want
              and not any(k.endswith("_ref") for k in counts),
              f"moe {spec}: launches {counts}, want {want} and no plain version")
        err = float((_spliced_logits(cfg16, rcfg, model, spec, prefix) - ref).abs().max())
        near = TOL_NEAR + 2 * FORMAT_TOL[spec]
        parted = [(r.uid, t) for r in greedy
                  if (t := first_divergence_near_tie(cfg16, rcfg, model, r, out16[r.uid].tokens,
                                                     out[r.uid].tokens, f"moe {spec} vs fp",
                                                     tag="moe serve", tol=near)) is not None]
        tf = [teacher_forced(cfg16, rcfg, model, r, out[r.uid].tokens, f"moe {spec}", tol=near)
              for r in greedy]
        print(f"[moe serve] {spec} pool, capacity factor 16: launches {counts} | decode "
              f"{st['decode_tok_s']:.1f} tok/s | p50 {st['p50_token_latency_ms']:.3f} / p95 "
              f"{st['p95_token_latency_ms']:.3f} ms per step | prefill {st['prefill_tok_s']:.1f} "
              f"tok/s | peak torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB | "
              f"kv_compression_x {eng.kv_compression_x:.3f} | first-step logits vs fp max |d| "
              f"{err:.4f} (printed; the JAX bound {FORMAT_TOL[spec]} is for f32 smoke archs) | "
              f"greedy streams parted from fp (uid, token): "
              f"{parted} | teacher-forced: {sum(d for d, _ in tf)} of {len(greedy) * GEN} "
              f"differ, largest gap {max(w for _, w in tf):.4f} (< {near}) {tag}")
        res[spec] = {"out": out, "counts": counts, "stats": st, "peak": peak}
        del eng
        torch.cuda.empty_cache()


def phase_moe_training(smi):
    """granite-moe-3b-a800m trained at full width and depth under
    attn.qkv and moe.expert PAMM (see the module docstring). Returns the
    per-step launch counts and the record."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.train import init_train_state

    cfg = get_config(MOE_ARCH)
    rcfg = RunConfig(compression=MOE_SPEC, policy_name="none", remat="pamm")
    tag = f"[{smi}]"
    n = TRAIN_STEPS
    state, step_fn, rec = _train_run(cfg, rcfg, n, measure=True)
    n_params = sum(p.numel() for p in state.params.parameters())
    per_step = {k: v / n for k, v in rec["counts"].items()}
    print(f"[moe train] {MOE_ARCH}: {n_params / 1e9:.3f} B params f32, compute "
          f"{rcfg.compute_dtype}, {MOE_SPEC}, remat='pamm', AdamW, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}; losses {rec['loss']} | grad norms "
          f"{[round(g, 4) for g in rec['gnorm']]}")
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
          "moe: a training loss or grad norm is not finite")
    L = cfg.n_layers
    want = {"csim_argmax": L, "csim_argmax_batched": L, "segment_matmul": 3 * L,
            "segment_matmul_batched": 2 * L, "flash_attention_fwd": 2 * L,
            "flash_attention_dq": L, "flash_attention_dkv": L, "flash_attention_fwd_f32": 0,
            "flash_attention_dq_f32": 0, "flash_attention_dkv_f32": 0}
    k1 = per_step.get("csim_argmax", 0) + per_step.get("csim_argmax_batched", 0)
    k2 = per_step.get("segment_matmul", 0) + per_step.get("segment_matmul_batched", 0)
    print(f"[moe train] launches per step {per_step} (K1 {k1:.0f}, K2 {k2:.0f})")
    check({k: per_step.get(k, 0) for k in want} == want,
          f"moe training launches per step {per_step} != {want}")
    check(not any(k.endswith("_ref") for k in rec["counts"]),
          "moe: a plain version ran on the training path")
    step_ms = statistics.median(rec["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[moe train] {1e3 * tokens / step_ms:.1f} tokens/s | {step_ms:.1f} ms per step "
          f"(median of {n}: {[round(t, 1) for t in rec['ms'][1:]]}; warm-up step "
          f"{rec['ms'][0]:.1f} ms) | step peak torch.cuda.max_memory_allocated "
          f"{rec['peak'] / 2**30:.3f} GiB {tag}")
    sites = {k: round(v, 6) for k, v in rec["metrics"].items() if k.startswith("site/")}
    print(f"[moe train] site telemetry (summed over {L} layers) {sites}")
    trace_training_step(state, step_fn, cfg, step_ms, n + 1, tag="moe ")
    rec["fb_peak"] = _fwd_bwd_peak(cfg, rcfg, state, TRAIN_SEQ)
    print(f"[moe train] forward + backward peak (one loss_and_grad, AdamW moments resident) "
          f"{rec['fb_peak'] / 2**30:.3f} GiB {tag}")
    del state, step_fn
    torch.cuda.empty_cache()

    _, _, rec2 = _train_run(cfg, rcfg, n, measure=False)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec2["loss"], rec["loss"])]
    print(f"[moe train] second run from seed {rcfg.seed}: losses {rec2['loss']} (step 0 "
          f"equal: {rec2['loss'][0] == rec['loss'][0]}; later steps worst rel "
          f"{max(rel[1:]):.2e}, tol 1e-3)")
    check(rec2["loss"][0] == rec["loss"][0] and max(rel[1:]) <= 1e-3,
          "moe: a second run from the seed gives other losses")
    torch.cuda.empty_cache()

    # the moe.expert site's saving on the card: forward + backward at 8 of
    # the 32 layers (remat='none' holds every layer's activations: all 32
    # would not fit next to the state), with and without the rule
    cut = dataclasses.replace(cfg, stages=((("moe",), MOE_CUT_LAYERS),),
                              n_layers=MOE_CUT_LAYERS)
    peaks = {}
    state = init_train_state(cut, rcfg, device="cuda")
    for label, spec in (("attn.qkv only", TRAIN_SPEC), ("attn.qkv + moe.expert", MOE_SPEC)):
        peaks[label] = _fwd_bwd_peak(cut, dataclasses.replace(rcfg, compression=spec,
                                                              remat="none"),
                                     state, TRAIN_SEQ)
    saved = peaks["attn.qkv only"] - peaks["attn.qkv + moe.expert"]
    print(f"[moe train] cut to {MOE_CUT_LAYERS} of {L} layers, remat='none', batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: forward + backward peak "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
          + f"; the moe.expert site saves {saved / 2**20:.1f} MiB "
          f"({saved / 2**20 / MOE_CUT_LAYERS:.1f} MiB a layer) {tag}")
    rec["cut_peaks"] = peaks
    del state
    torch.cuda.empty_cache()
    return per_step, rec


def phase_moe_numbers(gen, moe_serve, moe_train, smi, errs):
    """Kernel rows of the batched K1 / K2 at the moe.expert site's shapes,
    next to their plain versions and the bound; then K3-K7 at granite's
    shapes timed beside the same protocol (printed, not JSON rows)."""
    import torch

    from repro_torch.kernels.flash_decode import (flash_paged_decode_quant_cuda,
                                                  flash_paged_decode_quant_ref, quantize_kv)
    from repro_torch.kernels.pamm_apply import (segment_matmul_batched_cuda,
                                                segment_matmul_batched_ref)
    from repro_torch.kernels.pamm_compress import (csim_argmax_batched_cuda,
                                                   csim_argmax_batched_ref)

    tag = f"[{smi}]"
    per_step, _ = moe_train
    launches = {k: int(round(v * TRAIN_STEPS)) for k, v in per_step.items()}
    E, b, n, k, m = MOE_E, MOE_CAP, MOE_D, MOE_K, MOE_F
    x, c = moe_site_inputs(gen, E, b, n, k)
    f = csim_argmax_batched_cuda(x, c)[1]
    alpha = torch.randn((E, b), generator=gen, device="cuda")
    gz = _randn((E, b, m), gen)
    w1, w2 = k1_work(b, n, k, 2), k2_work(b, m, k, 2)
    k1 = _kernel_row("csim_argmax_batched (K1, the moe.expert site's experts in one launch)",
                     K1_SOURCE, K1_REPLACES, launches.get("csim_argmax_batched", 0), errs["K1b"],
                     lambda: csim_argmax_batched_cuda(x, c),
                     lambda: csim_argmax_batched_ref(x, c), None,
                     (E * w1[0], E * w1[1]))
    k2 = _kernel_row("segment_matmul_batched (K2, the moe.expert site's experts in one launch)",
                     K2_SOURCE, K2_REPLACES, launches.get("segment_matmul_batched", 0),
                     errs["K2b"], lambda: segment_matmul_batched_cuda(f, alpha, gz, k),
                     lambda: segment_matmul_batched_ref(f, alpha, gz, k), None,
                     (E * w2[0], E * w2[1]))
    note = f"launches on the moe training path ({TRAIN_STEPS} steps)"
    print_rows((k1, k2), ((note, f" at ({E} x {b}, {n}, k {k})"),
                          (note, f" at ({E} x {b}, m {m}, k {k})")), tag)
    del x, c, gz
    # the site's generator rows, drawn once a layer before K1: the experts
    # in one draw, against the draw per expert it replaced
    from repro_torch.core.keys import Key, choice_batched

    keys = Key(0).fold_in(1).split(E)
    draws = per_step.get("csim_argmax_batched", 0)
    for label, fn in (("one draw for the experts", lambda: choice_batched(keys, b, k, "cuda")),
                      ("a draw per expert", lambda: torch.stack(
                          [key.choice(b, k, "cuda") for key in keys]))):
        host = host_ms(fn, calls=20)
        print(f"[numbers] moe.expert generator rows ({E} experts x {b} rows, k {k}), {label}: "
              f"host {1e3 * host:.1f} us/call, {draws * host:.2f} ms a step ({draws:.0f} "
              f"draws) | wall {time_ms(fn, reps=10):.4f} ms/call {tag}")
    H, KV, dh = MOE_HEADS
    line = functools.partial(timed_line, "granite", tag)
    serving = moe_serve["dense"]["counts"].get("flash_attention_fwd", 0)
    for B, L in ((1, PROMPT_LEN), (TRAIN_BATCH, TRAIN_SEQ)):
        att = attention_inputs(gen, B, L, H, KV, dh)
        line(f"K3 ({B}, {L}, {H}/{KV}, {dh})", *att["K3"],
             f"{serving} launches serving" if B == 1 else
             f"{launches.get('flash_attention_fwd', 0)} launches training")
    for kern, name in (("K4", "flash_attention_dq"), ("K5", "flash_attention_dkv")):
        line(f"{kern} ({B}, {L}, {H}/{KV}, {dh})", *att[kern],
             f"{launches.get(name, 0)} launches training")
    del att
    q, kp, vp, qpos, bt, ppos = decode_lines(gen, line, H, KV, dh, 0, moe_serve)
    B = SLOTS
    for bits, label in ((8, "int8"), (4, "int4")):
        (kq, ks), (vq, vs) = (quantize_kv(t, bits, 1) for t in (kp, vp))
        ql = moe_serve[label]
        line(f"K8 {label} ({B} slots x 17 pages of {PAGE}, {H}/{KV}, {dh})",
             lambda: flash_paged_decode_quant_cuda(q, kq, vq, ks, vs, qpos, bt, ppos),
             lambda: flash_paged_decode_quant_ref(q, kq, vq, ks, vs, qpos, bt, ppos), None,
             paged_work(bt, ppos, qpos, H, KV, dh, kq.shape[-1] + 4 * ks.shape[-1], dh),
             f"{ql['counts'].get('flash_paged_decode_quant', 0)} launches on its serving run "
             f"({ql['stats']['decode_steps']} steps)")
    return [k1, k2]


# ---------------------------------------------------------------------------
# the ssm slice: mamba2-370m
# ---------------------------------------------------------------------------
def check_site_k1(gen, b, n, k, tag):
    """K1 (bf16) at a site's shape (b, n, k) against its plain version,
    two launches bitwise equal. Returns (max ||cs| - |cs_ref||, idx)."""
    import torch

    from repro_torch.kernels.pamm_compress import csim_argmax_cuda, csim_argmax_ref

    x = _randn((b, n), gen)
    c = x[torch.randperm(b, generator=gen, device="cuda")[:k]].contiguous()
    out, again = csim_argmax_cuda(x, c), csim_argmax_cuda(x, c)
    same = all(torch.equal(a, a2) for a, a2 in zip(out, again))
    cs, f, na = out
    cs_r, f_r, na_r = csim_argmax_ref(x, c)
    e_cs = (cs.abs() - cs_r.abs()).abs().max().item()
    e_n = ((na - na_r).abs() / na_r).max().item()
    csim = (x.float() @ c.float().T) / (na_r[:, None] * c.float().norm(dim=1)[None])
    if k == 1:                                     # one generator: idx 0 everywhere
        clear = torch.ones(b, dtype=torch.bool, device="cuda")
    else:
        top2 = csim.abs().topk(2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > TOL_K1_MARGIN
    n_bad = int((f[clear] != f_r[clear]).sum())
    print(f"[K1 {tag}] b={b} n={n} k={k} bf16: max||cs|-|cs_ref||={e_cs:.3e} max rel |norm "
          f"err|={e_n:.3e} (tol {TOL_K1}); idx equal on {int(clear.sum())}/{b} rows with a "
          f"top-2 margin > {TOL_K1_MARGIN} ({n_bad} differ); two launches bitwise equal: {same}")
    check(e_cs <= TOL_K1 and e_n <= TOL_K1 and n_bad == 0 and same,
          f"K1 disagrees with its plain version at the {tag} shape, or is not deterministic")
    return e_cs, f


def check_site_k2(gen, f, m, k, tag) -> float:
    """K2 (bf16 dZ) at a site's gradient shape (b, m, k, the idx ``f`` of
    K1) against its plain version at the rule's split count and at 3, two
    launches bitwise equal each; a ragged last column tile (m not a
    multiple of 256) is reported apart. Returns the largest error."""
    import torch

    from repro_torch.kernels import pamm_apply
    from repro_torch.kernels.pamm_apply import segment_matmul_cuda, segment_matmul_ref

    b = f.shape[0]
    alpha = torch.randn(b, generator=gen, device="cuda")
    gz = _randn((b, m), gen)
    ref = segment_matmul_ref(f, alpha, gz, k)
    scale = ref.abs().max().item()
    tail = m % 256
    worst = 0.0
    for splits in (None, 3):
        with k2_split_count(splits):
            got = segment_matmul_cuda(f, alpha, gz, k)
            again = segment_matmul_cuda(f, alpha, gz, k)
            S = pamm_apply._splits(b, m, k)[0]
        e = (got - ref).abs().max().item()
        same = bool(torch.equal(got, again))
        ragged = ""
        if tail:
            e_tail = (got[:, m - tail:] - ref[:, m - tail:]).abs().max().item()
            ragged = (f", in the ragged last column tile ({tail} of 256 columns) "
                      f"{e_tail:.3e}")
        print(f"[K2 {tag}] b={b} m={m} k={k} bf16, {S} splits"
              f"{' (the rule)' if splits is None else ' (forced)'}: max|B-B_ref|={e:.3e}"
              f"{ragged} (tol {TOL_K2} x {scale:.1f}); two launches bitwise equal: {same}")
        check(e <= TOL_K2 * scale and same,
              f"K2 disagrees or is not deterministic at m={m}, {S} splits")
        worst = max(worst, e)
    return worst


def phase_ssm_kernels(gen):
    """K1 at the ssm.in site's shape (8192 x 1024, k 16) and K2 at its
    gradient's (b 8192, k 16, m 4384: a ragged last column tile of 32), both
    bf16, each against its plain version with two launches bitwise equal;
    K2 also at 3 forced splits. Returns the largest errors."""
    import torch

    e1, f = check_site_k1(gen, TRAIN_BATCH * TRAIN_SEQ, SSM_D, SSM_K, "ssm.in")
    errs = {"K1": e1, "K2": check_site_k2(gen, f, SSM_M, SSM_K, "ssm.in")}
    torch.cuda.empty_cache()
    return errs


def serve_phase(cfg, rcfg, model, name, smi, want, pools, *, buckets: bool,
                paged_exact: bool = False, tf_layouts=("dense",)):
    """The serving phase's 16 requests through ``model`` at full size: a
    warm-up dense run, then the dense and paged fp layouts, each checked by
    ``served``: every request finished, finite logits, bucketing on iff
    ``buckets``, ``pools(eng, paged)`` (the page pools the layout builds),
    the launch counts ``want(st, paged)`` (every other attention kernel 0,
    no plain version). Then the dense tokens equal the warm-up's, greedy
    requests 0 and 1 alone equal to batched, paged tokens equal to dense
    (``paged_exact``) or parted only at near ties, every greedy token of
    each layout in ``tf_layouts`` against a teacher-forced forward, and a
    profiler split of one prefill and one decode block. Returns (engine,
    served, res): the engine factory, the checked run (for a phase's own
    requests) and each layout's record."""
    import torch

    from repro_torch.serve import ServeEngine

    engine = lambda layout="dense", max_len=MAX_LEN, slots=SLOTS: ServeEngine(
        cfg, rcfg, model, max_slots=slots, max_len=max_len, decode_block=DECODE_BLOCK,
        cache_layout=layout, page_size=PAGE)
    tag = f"[{smi}]"

    def served(label, eng, reqs, n_gen=GEN):
        out, counts = _counted(lambda: eng.run(reqs))
        st = eng.stats()
        paged = eng.cache_layout == "paged"
        check(sorted(out) == sorted(r.uid for r in reqs)
              and all(len(out[u].tokens) == n_gen for u in out),
              f"{name} {label}: not every request finished with {n_gen} tokens")
        check(st["nonfinite_logits"] == 0,
              f"{name} {label}: {st['nonfinite_logits']} non-finite logits rows")
        check(st["buckets_enabled"] is buckets,
              f"{name} {label}: buckets_enabled {st['buckets_enabled']}, want {buckets}")
        check(pools(eng, paged), f"{name} {label}: {len(eng.allocators)} page pools, or "
                                 f"the wrong ones, for the {eng.cache_layout} layout")
        w = {**{k: 0 for k in ATTN_KERNELS}, **want(st, paged)}
        check({k: counts.get(k, 0) for k in w} == w
              and not any(k.endswith("_ref") for k in counts),
              f"{name} {label}: launches {counts}, want {w} and no plain version")
        return out, counts, st

    reqs = _requests(cfg)
    warm = engine().run(reqs)
    res = {}
    for layout in ("dense", "paged"):
        torch.cuda.reset_peak_memory_stats()
        out, counts, st = served(layout, engine(layout), reqs)
        peak = torch.cuda.max_memory_allocated()
        print(f"[{name} serve] {layout}: launches {counts} | prefills {st['prefill_count']} | "
              f"decode steps {st['decode_steps']} | {st['prefill_buckets']} prefill buckets "
              f"(enabled {st['buckets_enabled']}) | cache {st['cache_slot_bytes'] / 2**20:.2f} "
              f"MiB a slot | decode {st['decode_tok_s']:.1f} tok/s | p50 "
              f"{st['p50_token_latency_ms']:.3f} / p95 {st['p95_token_latency_ms']:.3f} ms per "
              f"step | prefill {st['prefill_tok_s']:.1f} tok/s | peak "
              f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB {tag}")
        res[layout] = {"out": out, "counts": counts, "stats": st, "peak": peak}
    dense, paged = res["dense"]["out"], res["paged"]["out"]
    check(all(warm[u].tokens == dense[u].tokens for u in dense),
          f"{name} dense: a second run gave different tokens")
    for uid in (0, 1):                                 # greedy, alone
        solo = engine().run([r for r in reqs if r.uid == uid])[uid]
        check(solo.tokens == dense[uid].tokens,
              f"{name}: greedy request {uid} alone differs from its batched run")
    greedy = [r for r in reqs if r.sampling.temperature == 0]
    n_equal = sum(paged[u].tokens == dense[u].tokens for u in dense)
    if paged_exact:
        check(n_equal == N_REQUESTS, f"{name} paged: tokens differ from the dense run")
        vs_dense = "paged tokens identical to dense"
    else:
        parted = [(r.uid, t) for r in greedy
                  if (t := first_divergence_near_tie(cfg, rcfg, model, r, dense[r.uid].tokens,
                                                     paged[r.uid].tokens,
                                                     f"{name} paged vs dense",
                                                     tag=f"{name} serve")) is not None]
        vs_dense = (f"paged tokens equal to dense for {n_equal}/{N_REQUESTS} requests, greedy "
                    f"streams parted (uid, token) {parted}, each at a near tie")
    tf = {layout: [teacher_forced(cfg, rcfg, model, r, res[layout]["out"][r.uid].tokens,
                                  f"{name} {layout}") for r in greedy]
          for layout in tf_layouts}
    print(f"[{name} serve] second run identical; greedy requests 0 and 1 identical alone and "
          f"batched; {vs_dense}; every token of the {len(greedy)} greedy streams vs a "
          f"teacher-forced forward over its own tokens: "
          + "; ".join(f"{layout} {sum(d for d, _ in v)} of {len(greedy) * GEN} differ, "
                      f"largest gap to the top logit {max(w for _, w in v):.4f}"
                      for layout, v in tf.items())
          + f" (near tie < {TOL_NEAR})")
    st = res["dense"]["stats"]
    trace_breakdown(cfg, engine, model, {
        "prefill": 1e3 * st["prefill_s"] / max(1, st["prefill_count"]),
        "decode block": 1e3 * st["decode_s"] / max(1, st["decode_steps"]) * DECODE_BLOCK},
        tag=f"{name} ")
    return engine, served, res


def phase_ssm_serving(smi):
    """mamba2-370m served at full width cut to 8 of 48 layers
    (``SERVE_REPS``), bf16, random weights
    from seed 0, through :func:`serve_phase`: dense, then paged (no page
    pool: the state stays a dense slot cache; tokens equal the dense
    run's); bucketing off; no attention kernel launches (mamba2 has none:
    its serving path runs no hand-written kernel, as the JAX engine's runs
    no Pallas one)."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import init_model

    cfg = serve_cfg(SSM_ARCH)
    rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
    t0 = time.perf_counter()
    model = init_model(cfg, rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[ssm serve] {SSM_ARCH}: {n_params / 1e9:.3f} B params (bf16), {cfg.n_layers} "
          f"layers, d_inner {cfg.ssm_d_inner}, {cfg.ssm_nheads} heads of {cfg.ssm_headdim}, "
          f"state {cfg.ssm_state}, initialised on the card in {time.perf_counter() - t0:.1f} s")
    serve_phase(cfg, rcfg, model, "ssm", smi, lambda st, paged: {},
                lambda eng, paged: eng.allocators == [], buckets=False, paged_exact=True)
    del model
    torch.cuda.empty_cache()


def phase_ssm_training(smi):
    """mamba2-370m trained at full width and depth under ssm.in PAMM: f32
    params / bf16 compute, AdamW, batch 4 x 2048, remat SSM_REMAT; one
    warm-up and 3 measured steps (finite losses; launches a step K1 = K2 =
    48, the attention kernels and plain versions 0; the site's telemetry;
    step and forward + backward peaks; a profiler split), forward +
    backward under remat='none' with and without the ssm.in rule at a cut
    depth (the site's saving), and a second run from the seed. Returns
    the per-step launch counts and the record."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.train import init_train_state

    cfg = get_config(SSM_ARCH)
    rcfg = RunConfig(compression=SSM_SPEC, policy_name="none", remat=SSM_REMAT)
    tag = f"[{smi}]"
    n = TRAIN_STEPS
    state, step_fn, rec = _train_run(cfg, rcfg, n, measure=True)
    n_params = sum(p.numel() for p in state.params.parameters())
    per_step = {k: v / n for k, v in rec["counts"].items()}
    print(f"[ssm train] {SSM_ARCH}: {n_params / 1e9:.3f} B params f32, compute "
          f"{rcfg.compute_dtype}, {SSM_SPEC}, remat={SSM_REMAT!r}, AdamW, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}; losses {rec['loss']} | grad norms {[round(g, 4) for g in rec['gnorm']]}")
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
          "ssm: a training loss or grad norm is not finite")
    L = cfg.n_layers
    want = {"csim_argmax": L, "segment_matmul": L, **{k: 0 for k in ATTN_KERNELS}}
    print(f"[ssm train] launches per step {per_step}")
    check({k: per_step.get(k, 0) for k in want} == want
          and not any(k.endswith("_ref") for k in rec["counts"]),
          f"ssm training launches per step {per_step} != {want}, or a plain version ran")
    step_ms = statistics.median(rec["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[ssm train] {1e3 * tokens / step_ms:.1f} tokens/s | {step_ms:.1f} ms per step "
          f"(median of {n}: {[round(t, 1) for t in rec['ms'][1:]]}; warm-up step "
          f"{rec['ms'][0]:.1f} ms) | step peak torch.cuda.max_memory_allocated "
          f"{rec['peak'] / 2**30:.3f} GiB {tag}")
    sites = {k: round(v, 6) for k, v in rec["metrics"].items() if k.startswith("site/")}
    print(f"[ssm train] site telemetry (summed over {L} layers) {sites}")
    trace_training_step(state, step_fn, cfg, step_ms, n + 1, tag="ssm ")
    rec["fb_peak"] = _fwd_bwd_peak(cfg, rcfg, state, TRAIN_SEQ)
    print(f"[ssm train] forward + backward peak (one loss_and_grad, AdamW moments resident) "
          f"{rec['fb_peak'] / 2**30:.3f} GiB {tag}")
    del state, step_fn
    torch.cuda.empty_cache()
    # the site's saving: forward + backward under remat='none' with and
    # without the rule, at SSM_CUT_LAYERS of the 48 layers (all 48 do not
    # fit under 'none'), a fresh state's AdamW moments resident in both
    cut = dataclasses.replace(cfg, stages=((("ssm",), SSM_CUT_LAYERS),),
                              n_layers=SSM_CUT_LAYERS)
    state = init_train_state(cut, rcfg, device="cuda")
    peaks = {label: _fwd_bwd_peak(cut, dataclasses.replace(rcfg, compression=spec,
                                                           remat="none"), state, TRAIN_SEQ)
             for label, spec in (("ssm.in exact", "ssm.in=none"), (SSM_SPEC, SSM_SPEC))}
    saved = peaks["ssm.in exact"] - peaks[SSM_SPEC]
    rec["cut_peaks"] = peaks
    print(f"[ssm train] cut to {SSM_CUT_LAYERS} of {L} layers, remat='none', batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: forward + backward peak "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
          + f"; the ssm.in site saves {saved / 2**20:.1f} MiB ({saved / 2**20 / SSM_CUT_LAYERS:.2f}"
          f" MiB a layer; its bf16 input is {tokens * SSM_D * 2 / 2**20:.1f} MiB a layer) {tag}")
    del state
    torch.cuda.empty_cache()
    _, _, rec2 = _train_run(cfg, rcfg, n, measure=False)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec2["loss"], rec["loss"])]
    print(f"[ssm train] second run from seed {rcfg.seed}: losses {rec2['loss']} (step 0 "
          f"equal: {rec2['loss'][0] == rec['loss'][0]}; later steps worst rel "
          f"{max(rel[1:]):.2e}, tol 1e-3)")
    check(rec2["loss"][0] == rec["loss"][0] and max(rel[1:]) <= 1e-3,
          "ssm: a second run from the seed gives other losses")
    torch.cuda.empty_cache()
    return per_step, rec


def phase_ssm_numbers(gen, per_step, rec, smi, errs):
    """Kernel rows of K1 and K2 at the ssm.in site's shapes (plain version,
    bound, launches on the mamba2 training path)."""
    tag = f"[{smi}]"
    launches = {k: int(round(v * TRAIN_STEPS)) for k, v in per_step.items()}
    b, n, m, k = TRAIN_BATCH * TRAIN_SEQ, SSM_D, SSM_M, SSM_K
    rows, _ = site_k1_k2_rows(
        gen, b, n, k, "csim_argmax (K1, mamba2's ssm.in site)",
        [(m, "segment_matmul (K2, mamba2's ssm.in site, a ragged last column tile)")],
        launches, errs)
    note = f"launches on the mamba2 training path ({TRAIN_STEPS} steps)"
    print_rows(rows, ((note, f" at ({b}, {n}, k {k})"), (note, f" at (b {b}, m {m}, k {k})")),
               tag)
    step_ms = statistics.median(rec["ms"][1:])
    L = int(per_step.get("csim_argmax", 0))
    print(f"[numbers] mamba2 train step {step_ms:.1f} ms: K1 x{L} "
          f"{L * rows[0]['ms']:.2f} ms, K2 x{L} {L * rows[1]['ms']:.2f} ms (isolated, L2 "
          f"flushed) {tag}")
    return rows


def run_ssm_phases(gen, smi):
    """Phases 18-21: K1 / K2 at the ssm.in site's shapes against their
    plain versions, mamba2-370m served and trained, mamba2 smoke card
    against CPU, the ssm kernel rows. Returns the rows."""
    errs = phase_ssm_kernels(gen)
    phase_ssm_serving(smi)
    per_step, rec = phase_ssm_training(smi)
    phase_card_vs_cpu(SSM_SMOKE, SSM_SMOKE_SPEC)
    return phase_ssm_numbers(gen, per_step, rec, smi, errs)


# ---------------------------------------------------------------------------
# the rec slice: recurrentgemma-9b
# ---------------------------------------------------------------------------
def phase_rec_kernels(gen):
    """K3-K8 at recurrentgemma's heads (16 / 1 of 256) and K1 / K2 at its
    sites' shapes, bf16 unless stated, each against its plain version:
    K4/K5 (fed K3's o and lse) at the training shape (4, 2048) with window
    2048 and at a ragged (1, 1030) with window 256, two launches bitwise
    equal, and one f32-route case; K3 at the long prompt (1, 2100) with
    window 2048 (rows past 2048 lose their first keys); K6 over the cell's
    1089-slot cache and over a wrapped 2048-slot ring; K7 and K8 (int8)
    at the cell's paged decode shape and over a ring pool of 2048; K1 at
    (8192, 4096, k 16) and K2 at m 4096 and 256 (the rule's split count and
    3), two launches bitwise equal. Returns the largest errors."""
    import torch

    H, KV, dh = REC_HEADS
    bf16 = torch.bfloat16
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0, "K7": 0.0,
            "K8": 0.0}
    check_k3_k45(gen, TRAIN_BATCH, TRAIN_SEQ, H, KV, dh, REC_WINDOW, None, bf16, errs,
                 repeat=True)
    check_k3_k45(gen, 1, 1030, H, KV, dh, 256, None, bf16, errs, repeat=True)
    check_k3_k45(gen, 1, 300, H, KV, dh, 64, None, torch.float32, errs)
    q = _randn((1, REC_LONG_PROMPT, H, dh), gen)
    k, v = (_randn((1, REC_LONG_PROMPT, KV, dh), gen) for _ in range(2))
    e, _, _ = check_k3(q, k, v, window=REC_WINDOW, label=", the long prompt")
    errs["K3"] = max(errs["K3"], e)
    del q, k, v
    errs["K6"] = max(check_k6(gen, SLOTS, MAX_LEN, H, KV, dh, ring=False),
                     check_k6(gen, SLOTS, MAX_LEN, H, KV, dh, ring=True,
                              ring_slots=REC_WINDOW, n_ring=REC_LONG_PROMPT + MID_DECODE))
    for case in (("recurrentgemma heads, row 3 parked", dh, 1, False, 0, None, None, None),
                 ("recurrentgemma heads, a ring pool of 2048", dh, 1, False, REC_WINDOW, None,
                  None, None),
                 ("recurrentgemma heads, int8 ngr 1, a hole", dh, 1, True, 0, None, (8, 1),
                  None),
                 ("recurrentgemma heads, int8 ngr 1, a ring pool of 2048", dh, 1, False,
                  REC_WINDOW, None, (8, 1), None)):
        name, e = check_paged(gen, *case, H=H, KV=KV)
        errs[name] = max(errs[name], e)
    errs["K1"], f = check_site_k1(gen, TRAIN_BATCH * TRAIN_SEQ, REC_D, REC_K, "rec")
    errs["K2"] = max(check_site_k2(gen, f, m, REC_K, "rec") for m in REC_M)
    torch.cuda.empty_cache()
    return errs


def _n_kind(cfg, kind: str) -> int:
    return sum(rep * unit.count(kind) for unit, rep in cfg.stages)


def phase_rec_serving(smi):
    """recurrentgemma-9b served at full width cut to 11 of 38 layers (3
    latt; ``SERVE_REPS``), bf16, random
    weights from seed 0, through :func:`serve_phase`: dense then paged fp
    (the latt blocks' ring pools), launches K3 = 3 x prefills and K6 / K7
    = 3 x decode steps, bucketing off; then one request of a 2100-token
    prompt in an engine of max_len 2176, dense and paged, whose 2048-slot
    ring wraps in prefill (the ring holds positions 52 to 2099 after it)
    and in decode. Returns the dense and paged records."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import init_model, prefill
    from repro_torch.models.attention import KVCache

    cfg = serve_cfg(REC_ARCH)
    rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
    t0 = time.perf_counter()
    model = init_model(cfg, rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_latt = _n_kind(cfg, "latt")
    print(f"[rec serve] {REC_ARCH}: {n_params / 1e9:.3f} B params (bf16), {cfg.n_layers} "
          f"layers ({_n_kind(cfg, 'rec')} rec, {n_latt} latt), lru_width {cfg.lru_width}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, local_window "
          f"{cfg.local_window}, initialised on the card in {time.perf_counter() - t0:.1f} s; "
          f"memory allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    tag = f"[{smi}]"
    want = lambda st, paged: {
        "flash_attention_fwd": n_latt * st["prefill_count"],
        "flash_decode": 0 if paged else n_latt * st["decode_steps"],
        "flash_paged_decode": n_latt * st["decode_steps"] if paged else 0}
    pools = lambda eng, paged: (len(eng.allocators) == (1 if paged else 0)
                                and all(a.spec.ring for a in eng.allocators))
    engine, served, res = serve_phase(cfg, rcfg, model, "rec", smi, want, pools, buckets=False)
    # the long request: the ring wraps in prefill and keeps wrapping in decode
    args = argparse.Namespace(prompt_len=REC_LONG_PROMPT, requests=1, gen=GEN,
                              temperature=0.0, top_k=0, seed=0)
    from repro_torch.launch.serve import _build_requests

    long_req = _build_requests(cfg, args)[0]
    _, caches = prefill(cfg, rcfg, model, {"tokens": torch.tensor([long_req.tokens],
                                                                   device="cuda")},
                        REC_LONG_MAX)
    ring = next(node for node in caches[0] if isinstance(node, KVCache))
    held = sorted(ring.slot_pos[0, 0].tolist())
    first = REC_LONG_PROMPT - REC_WINDOW
    check(ring.ring and held == list(range(first, REC_LONG_PROMPT)),
          f"rec long prompt: the ring holds positions {held[:3]}..{held[-3:]}, want "
          f"{first}..{REC_LONG_PROMPT - 1}")
    del caches, ring
    long_out = {}
    for layout in ("dense", "paged"):
        out, counts, st = served(f"long {layout}", engine(layout, REC_LONG_MAX, 1), [long_req])
        long_out[layout] = out[long_req.uid].tokens
        d, w = teacher_forced(cfg, rcfg, model, long_req, long_out[layout], f"rec long {layout}")
        print(f"[rec serve] long request ({REC_LONG_PROMPT}-token prompt, max_len "
              f"{REC_LONG_MAX}, a {REC_WINDOW}-slot ring holding positions {first}.."
              f"{REC_LONG_PROMPT - 1} after prefill), {layout}: launches {counts} | decode "
              f"{st['decode_tok_s']:.1f} tok/s | prefill {st['prefill_tok_s']:.1f} tok/s | "
              f"teacher-forced: {d} of {GEN} differ, largest gap {w:.4f} (< {TOL_NEAR}) {tag}")
    first_divergence_near_tie(cfg, rcfg, model, long_req, long_out["dense"], long_out["paged"],
                              "rec long paged vs dense", tag="rec serve")
    del model
    torch.cuda.empty_cache()
    return res


def _rec_hotspots(cut, step_ms, tag):
    """Device time of the two f32 pieces of a rec layer that the JAX
    package leaves to XLA, at the training shape (TF32 off), against the
    step time: a gate product (8192 x 4096 @ 4096 x 4096: w_a and w_i once
    each a forward pass, the recompute's included, and their dx and dW in
    backward) and the linear scan (forward, and forward + backward)."""
    import torch

    from repro_torch.models.rglru import LinearScan

    n_rec = _n_kind(cut, "rec")
    tokens, w = TRAIN_BATCH * TRAIN_SEQ, cut.lru_width
    x = torch.randn((tokens, w), device="cuda")
    wa = torch.randn((w, w), device="cuda")
    gemm = time_ms(lambda: x @ wa, reps=10)
    a = torch.rand((TRAIN_BATCH, TRAIN_SEQ, w), device="cuda").requires_grad_()
    b = torch.randn((TRAIN_BATCH, TRAIN_SEQ, w), device="cuda").requires_grad_()
    g = torch.randn_like(b)
    fwd = time_ms(lambda: LinearScan.apply(a, b), reps=10)
    fb = time_ms(lambda: torch.autograd.grad(LinearScan.apply(a, b), (a, b), g), reps=10)
    passes = 2 if REC_REMAT != "none" else 1         # the recompute runs the forward again
    n_gemm = n_rec * (2 * passes + 4)                # w_a, w_i: forward; dx and dW each
    scan_ms = n_rec * ((passes - 1) * fwd + fb)
    print(f"[rec train] f32 gate product ({tokens} x {w} @ {w} x {w}, TF32 off) {gemm:.3f} ms; "
          f"{n_gemm} a step = {n_gemm * gemm:.1f} ms ({100 * n_gemm * gemm / step_ms:.1f}% of "
          f"the {step_ms:.1f} ms step) | linear scan ({TRAIN_BATCH}, {TRAIN_SEQ}, {w}) f32: "
          f"forward {fwd:.3f} ms, forward + backward {fb:.3f} ms; a step {scan_ms:.1f} ms "
          f"({100 * scan_ms / step_ms:.1f}%) (isolated, CUDA events) {tag}")
    del x, wa, a, b, g
    torch.cuda.empty_cache()


def phase_rec_training(smi):
    """recurrentgemma-9b at full width, cut to the smoke arch's stage layout
    (5 layers), trained under attn.qkv and rglru.in PAMM: f32 params / bf16
    compute, AdamW, batch 4 x 2048, remat REC_REMAT; one warm-up and 3
    measured steps (finite losses; launches a step K1 5, K2 7, K3 1 (2
    where the remat mode recomputes), K4 = K5 1; telemetry; step and
    forward + backward peaks; a profiler split; the f32 gate products' and
    the scan's time), the sites' saving under remat='none' at
    REC_CUT_STAGES, and a second run from the seed. Returns the per-step
    launch counts and the record."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.train import init_train_state

    full = get_config(REC_ARCH)
    cut = dataclasses.replace(full, stages=REC_TRAIN_STAGES,
                              n_layers=sum(len(u) * r for u, r in REC_TRAIN_STAGES))
    rcfg = RunConfig(compression=REC_SPEC, policy_name="none", remat=REC_REMAT)
    tag = f"[{smi}]"
    n = TRAIN_STEPS
    state, step_fn, rec = _train_run(cut, rcfg, n, measure=True)
    n_params = sum(p.numel() for p in state.params.parameters())
    per_step = {k: v / n for k, v in rec["counts"].items()}
    n_rec, n_latt = _n_kind(cut, "rec"), _n_kind(cut, "latt")
    print(f"[rec train] {REC_ARCH} cut to {cut.n_layers} of {full.n_layers} layers "
          f"{REC_TRAIN_STAGES}: {n_params / 1e9:.3f} B params f32, compute "
          f"{rcfg.compute_dtype}, {REC_SPEC}, remat={REC_REMAT!r}, AdamW, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}; losses {rec['loss']} | grad norms {[round(g, 4) for g in rec['gnorm']]}")
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
          "rec: a training loss or grad norm is not finite")
    want = {"csim_argmax": n_rec + n_latt, "segment_matmul": n_rec + 3 * n_latt,
            "flash_attention_fwd": (1 if REC_REMAT == "none" else 2) * n_latt,
            "flash_attention_dq": n_latt, "flash_attention_dkv": n_latt,
            **{k: 0 for k in ATTN_KERNELS if k.endswith("_f32") or "decode" in k}}
    print(f"[rec train] launches per step {per_step}")
    check({k: per_step.get(k, 0) for k in want} == want
          and not any(k.endswith("_ref") for k in rec["counts"]),
          f"rec training launches per step {per_step} != {want}, or a plain version ran")
    step_ms = statistics.median(rec["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[rec train] {1e3 * tokens / step_ms:.1f} tokens/s | {step_ms:.1f} ms per step "
          f"(median of {n}: {[round(t, 1) for t in rec['ms'][1:]]}; warm-up step "
          f"{rec['ms'][0]:.1f} ms) | step peak torch.cuda.max_memory_allocated "
          f"{rec['peak'] / 2**30:.3f} GiB {tag}")
    sites = {k: round(v, 6) for k, v in rec["metrics"].items() if k.startswith("site/")}
    print(f"[rec train] site telemetry (summed over the layers) {sites}")
    trace_training_step(state, step_fn, cut, step_ms, n + 1, tag="rec ")
    rec["fb_peak"] = _fwd_bwd_peak(cut, rcfg, state, TRAIN_SEQ)
    print(f"[rec train] forward + backward peak (one loss_and_grad, AdamW moments resident) "
          f"{rec['fb_peak'] / 2**30:.3f} GiB {tag}")
    del state, step_fn
    torch.cuda.empty_cache()
    _rec_hotspots(cut, step_ms, tag)
    # the sites' saving: forward + backward under remat='none' at
    # REC_CUT_STAGES, exact, with attn.qkv alone and with both rules
    small = dataclasses.replace(full, stages=REC_CUT_STAGES,
                                n_layers=sum(len(u) * r for u, r in REC_CUT_STAGES))
    state = init_train_state(small, rcfg, device="cuda")
    specs = (("exact", ""), ("attn.qkv", "attn.qkv=pamm(r=1/512)"), ("both", REC_SPEC))
    peaks = {label: _fwd_bwd_peak(small, dataclasses.replace(rcfg, compression=spec,
                                                             remat="none"), state, TRAIN_SEQ)
             for label, spec in specs}
    rec["cut_peaks"] = peaks
    qkv, rg = peaks["exact"] - peaks["attn.qkv"], peaks["attn.qkv"] - peaks["both"]
    print(f"[rec train] cut to {REC_CUT_STAGES}, remat='none', batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: forward + backward peak "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
          + f"; attn.qkv saves {qkv / 2**20:.1f} MiB ({_n_kind(small, 'latt')} latt layer), "
          f"rglru.in {rg / 2**20:.1f} MiB ({rg / 2**20 / _n_kind(small, 'rec'):.1f} MiB a rec "
          f"layer; a layer's bf16 input is {tokens * REC_D * 2 / 2**20:.1f} MiB) {tag}")
    del state
    torch.cuda.empty_cache()
    _, _, rec2 = _train_run(cut, rcfg, n, measure=False)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec2["loss"], rec["loss"])]
    print(f"[rec train] second run from seed {rcfg.seed}: losses {rec2['loss']} (step 0 "
          f"equal: {rec2['loss'][0] == rec['loss'][0]}; later steps worst rel "
          f"{max(rel[1:]):.2e}, tol 1e-3)")
    check(rec2["loss"][0] == rec["loss"][0] and max(rel[1:]) <= 1e-3,
          "rec: a second run from the seed gives other losses")
    torch.cuda.empty_cache()
    return per_step, rec


def phase_rec_numbers(gen, serve, per_step, rec, smi, errs):
    """Kernel rows at recurrentgemma's shapes (plain version, SDPA where it
    computes the same function, bound, launches on the rec training path):
    K3, K4 and K5 at the training shape (4, 2048, 16 / 1, 256), K1 at
    (8192, 4096, k 16), K2 at m 4096 and 256; then K3 at the serving
    prefill shape and K6 / K7 at the cell's decode shapes, printed."""
    import torch

    tag = f"[{smi}]"
    launches = {k: int(round(v * TRAIN_STEPS)) for k, v in per_step.items()}
    H, KV, dh = REC_HEADS
    B, L, W = TRAIN_BATCH, TRAIN_SEQ, REC_WINDOW
    at = f"({B}, {L}, {H}/{KV}, {dh}), window {W}"
    att = attention_inputs(gen, B, L, H, KV, dh, W)
    rows = [
        _kernel_row(f"flash_attention_fwd (K3, recurrentgemma's latt heads, {at})", K3_SOURCE,
                    K3_REPLACES, launches.get("flash_attention_fwd", 0), errs["K3"], *att["K3"]),
        _kernel_row(f"flash_attention_dq (K4, dh 256: two 128-wide halves, {at})", K45_SOURCE,
                    K4_REPLACES, launches.get("flash_attention_dq", 0), errs["K4"], *att["K4"]),
        _kernel_row(f"flash_attention_dkv (K5, dh 256: two 128-wide halves, {at})",
                    K45_SOURCE, K5_REPLACES, launches.get("flash_attention_dkv", 0),
                    errs["K5"], *att["K5"])]
    del att
    torch.cuda.empty_cache()
    b, n, k = TRAIN_BATCH * TRAIN_SEQ, REC_D, REC_K
    rows += site_k1_k2_rows(
        gen, b, n, k, "csim_argmax (K1, recurrentgemma's rglru.in and attn.qkv sites)",
        [(m, f"segment_matmul (K2, recurrentgemma's "
             f"{'w_x and wq' if m == REC_D else 'wk and wv'}, m {m})") for m in REC_M],
        launches, errs)[0]
    print_rows(rows, [(f"launches on the rec training path ({TRAIN_STEPS} steps)", "")]
               * len(rows), tag)
    step_ms = statistics.median(rec["ms"][1:])
    print(f"[numbers] rec train step {step_ms:.1f} ms: "
          + ", ".join(f"{r['name'].split(' (')[0]} x{r['launches'] // TRAIN_STEPS} "
                      f"{r['launches'] // TRAIN_STEPS * r['ms']:.2f} ms" for r in rows[:4])
          + f" (isolated, L2 flushed) {tag}")
    line = functools.partial(timed_line, "recurrentgemma", tag)
    att = attention_inputs(gen, 1, PROMPT_LEN, H, KV, dh, W)
    line(f"K3 (1, {PROMPT_LEN}, {H}/{KV}, {dh}), window {W}", *att["K3"],
         f"{serve['dense']['counts'].get('flash_attention_fwd', 0)} launches serving")
    del att
    decode_lines(gen, line, H, KV, dh, W, serve)
    return rows


def run_rec_phases(gen, smi):
    """Phases 22-25: recurrentgemma's kernels against their plain
    versions, recurrentgemma-9b served at full width (11 layers) and trained at a cut
    depth, recurrentgemma smoke card against CPU (residual and
    reversible), the rec kernel rows. Returns the rows."""
    errs = phase_rec_kernels(gen)
    serve = phase_rec_serving(smi)
    phase_card_vs_cpu(REC_SMOKE, REC_SMOKE_SPEC)
    phase_reversible_card_vs_cpu(REC_SMOKE, REC_SMOKE_SPEC)
    per_step, rec = phase_rec_training(smi)
    return phase_rec_numbers(gen, serve, per_step, rec, smi, errs)


def set_gates(model, value: float = VIS_GATE) -> int:
    """Fill every xattn block's gate_attn and gate_ffn (zero at init, which
    makes the block the identity) with ``value``, in place. Returns the
    number of xattn layers."""
    import torch

    n = 0
    with torch.no_grad():
        for stage in model.stages:
            for block in stage:
                if block.kind == "xattn":
                    block.gate_ffn.fill_(value)
                    block.attn.gate_attn.fill_(value)
                    n += block.rep
    return n


def cross_decode_inputs(gen, B, S, H, KV, dh, dtype=None, parked: int | None = None):
    """K6's non-causal inputs at an xattn layer's decode shape: q (B, 1,
    H, dh), the image K / V (B, S, KV, dh), q_pos 0 (-1 on row ``parked``:
    a parked slot still runs the xattn decode) and slot_pos arange(S)."""
    import torch

    q = _randn((B, 1, H, dh), gen, dtype)
    k, v = _randn((B, S, KV, dh), gen, dtype), _randn((B, S, KV, dh), gen, dtype)
    qpos = torch.zeros((B,), dtype=torch.int32, device="cuda")
    if parked is not None:
        qpos[parked] = -1
    spos = torch.arange(S, dtype=torch.int32, device="cuda").repeat(B, 1)
    return q, k, v, qpos, spos


def check_k6_cross(gen, B, S, H, KV, dh, *, dtype=None, parked: int | None = None) -> float:
    """K6 non-causal against its plain version: max |o - o_ref| under
    TOL_O and every output row (a head of a slot) within TOL_ROW of its
    own norm; two launches bitwise equal; each row alone bitwise equal to
    it in the batch (the split count is a function of S alone). Returns
    max |o - o_ref|."""
    import torch

    from repro_torch.kernels.flash_decode import (_dense_splits, flash_decode_cuda,
                                                  flash_decode_ref)

    q, k, v, qpos, spos = cross_decode_inputs(gen, B, S, H, KV, dh, dtype, parked)
    run = lambda b0, b1: flash_decode_cuda(q[b0:b1], k[b0:b1], v[b0:b1], qpos[b0:b1],
                                           spos[b0:b1], causal=False)
    o, again = run(0, B), run(0, B)
    check(torch.equal(o, again), f"K6 non-causal: a second launch gave other bits (S={S})")
    alone = all(torch.equal(run(b, b + 1), o[b:b + 1]) for b in range(B))
    check(alone, f"K6 non-causal: a row decoded alone differs from it at B={B} (S={S})")
    o_r = flash_decode_ref(q, k, v, qpos, spos, causal=False)
    e = (o.float() - o_r.float()).abs().max().item()
    e_row = row_err(o.reshape(-1, dh), o_r.reshape(-1, dh))
    n, per = _dense_splits(S)
    print(f"[K6 cross] B={B} S={S} ({n} splits of {per}, the last {S - (n - 1) * per} wide) "
          f"H={H} KV={KV} dh={dh} {str(q.dtype).split('.')[-1]} causal=False q_pos 0"
          + ("" if parked is None else f" (row {parked} parked at -1)")
          + f": max|o-o_ref|={e:.3e} (tol {TOL_O}); worst row rel {e_row:.3e} (tol "
          f"{TOL_ROW}); two launches bitwise equal; each row alone bitwise equal to it at "
          f"B={B}")
    check(bool(o.isfinite().all()), "K6 non-causal output is not finite")
    check(e <= TOL_O and e_row <= TOL_ROW,
          f"K6 non-causal disagrees with its plain version at S={S}")
    return e


def phase_vision_kernels(gen):
    """llama-vision's kernels at its 32 / 8 heads of 128 (G 4), each
    against its plain version: K6 non-causal over 8 slots x 1601 image
    slots in bf16, with a parked row, and in f32; K3 at the prefill shape
    (1, 1024) in bf16 and at (1, 1000) in f32; K3 and K4/K5 (fed K3's o
    and lse) at the training shape (4, 2048), two launches bitwise equal;
    K6 causal over the 1089-slot decode cache; K7 at the paged decode
    shape (8 x 17 pages of 64: a parked row, a hole at 1 split) and K8
    int8 beside it; K1 at the attn.cross_kv site's (6404, 4096, k 13) and
    K2 at its gradient's (b 6404, m 1024), bf16, two launches bitwise
    equal. Returns the largest errors ("K6 cross" the non-causal route's,
    "K6" the causal one's)."""
    import torch

    H, KV, dh = VIS_HEADS
    bf16 = torch.bfloat16
    errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0, "K7": 0.0, "K8": 0.0}
    errs["K6 cross"] = max(check_k6_cross(gen, SLOTS, VIS_TOKENS, H, KV, dh),
                           check_k6_cross(gen, SLOTS, VIS_TOKENS, H, KV, dh, parked=3),
                           check_k6_cross(gen, SLOTS, VIS_TOKENS, H, KV, dh,
                                          dtype=torch.float32, parked=5))
    for B, L, dtype in ((1, PROMPT_LEN, bf16), (1, 1000, torch.float32)):
        q = _randn((B, L, H, dh), gen, dtype)
        kk, v = _randn((B, L, KV, dh), gen, dtype), _randn((B, L, KV, dh), gen, dtype)
        e, _, _ = check_k3(q, kk, v, window=0, label=", llama-vision serving shape")
        if dtype == bf16:
            errs["K3"] = max(errs["K3"], e)
    del q, kk, v
    check_k3_k45(gen, TRAIN_BATCH, TRAIN_SEQ, H, KV, dh, 0, None, bf16, errs, repeat=True)
    errs["K6"] = check_k6(gen, SLOTS, MAX_LEN, H, KV, dh, ring=False)
    for case in (("llama-vision heads, shuffled, row 3 parked", dh, 1, False, 0, None, None,
                  None),
                 ("llama-vision heads, a hole, 1 split", dh, 1, True, 0, None, None, 1),
                 ("llama-vision heads, int8 ngr 1, a hole", dh, 1, True, 0, None, (8, 1),
                  None)):
        name, e = check_paged(gen, *case, H=H, KV=KV)
        errs[name] = max(errs[name], e)
    errs["K1"], f = check_site_k1(gen, VIS_CROSS_B, VIS_D, VIS_CROSS_K, "cross_kv")
    errs["K2"] = check_site_k2(gen, f, VIS_CROSS_M, VIS_CROSS_K, "cross_kv")
    torch.cuda.empty_cache()
    return errs


def phase_vision_serving(smi):
    """llama-3.2-vision-11b served at full width cut to 1 of its 8 units
    (5 layers; ``SERVE_REPS``), bf16, random
    weights from seed 0, every gate filled with VIS_GATE, through
    :func:`serve_phase`: each request with its own image embeddings from
    the stream, dense then paged fp. Launches K3 = 8 x prefills; dense K6
    = 10 x decode steps (8 causal, 2 non-causal); paged K7 = 8 x decode
    steps and K6 = 2 x decode steps, every one of them non-causal.
    Bucketing on; the xattn cache stays a dense slot cache; both layouts
    teacher-forced. Returns the dense and paged records."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import init_model
    from repro_torch.models.attention import XAttnCache

    cfg = serve_cfg(VIS_ARCH)
    rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
    t0 = time.perf_counter()
    model = init_model(cfg, rcfg, seed=0, device="cuda")
    n_x = set_gates(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_attn = _n_kind(cfg, "attn")
    n_pools = sum(unit.count("attn") for unit, _ in cfg.stages)   # a node per unit position
    print(f"[vision serve] {VIS_ARCH}: {n_params / 1e9:.3f} B params (bf16), {cfg.n_layers} "
          f"layers ({n_attn} attn, {n_x} xattn), {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.vision_tokens} image tokens, initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s; gate_attn and gate_ffn of the {n_x} xattn "
          f"layers filled with {VIS_GATE} (zero at init); memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    check(all(r.image_embeds is not None and r.image_embeds.shape == (cfg.vision_tokens,
                                                                       cfg.d_model)
              for r in _requests(cfg)), "vision: a request without its image embeddings")
    want = lambda st, paged: {
        "flash_attention_fwd": n_attn * st["prefill_count"],
        "flash_decode": (n_x if paged else n_attn + n_x) * st["decode_steps"],
        "flash_paged_decode": n_attn * st["decode_steps"] if paged else 0}
    pools = lambda eng, paged: (isinstance(eng.caches[0][4], XAttnCache)
                                and len(eng.allocators) == (n_pools if paged else 0))
    _, _, res = serve_phase(cfg, rcfg, model, "vision", smi, want, pools, buckets=True,
                            tf_layouts=("dense", "paged"))
    del model
    torch.cuda.empty_cache()
    return res


def _vision_hotspots(cut, rcfg, step_ms, tag):
    """Device time of the xattn layers' attention core at the training
    shape: the chunked f32 einsum ``sdpa`` of (4, 2048) queries over 4 x
    1601 image keys at 32 / 8 heads of 128 (no kernel takes Lq != Lk),
    bf16 in and out as the step feeds it; its forward alone, and what a
    step runs under ``flash_sdp`` (the checkpointed forward, its recompute
    and the backward), against the step time."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.attention import sdpa

    H, KV, dh = VIS_HEADS
    B, Lq, Lk = TRAIN_BATCH, TRAIN_SEQ, VIS_TOKENS
    bf16 = torch.bfloat16
    q = torch.randn((B, Lq, H, dh), device="cuda", dtype=bf16).requires_grad_()
    k, v = (torch.randn((B, Lk, KV, dh), device="cuda", dtype=bf16).requires_grad_()
            for _ in range(2))
    sdp = functools.partial(
        sdpa, q_pos=torch.arange(Lq, dtype=torch.int32, device="cuda").expand(B, Lq),
        k_pos=torch.arange(Lk, dtype=torch.int32, device="cuda").expand(B, Lk),
        causal=False, window=0, chunk=rcfg.attn_chunk)
    g = torch.randn((B, Lq, H, dh), device="cuda", dtype=bf16)
    with torch.no_grad():
        fwd = time_ms(lambda: sdp(q, k, v), reps=10)
    fb = time_ms(lambda: torch.autograd.grad(checkpoint(sdp, q, k, v, use_reentrant=False),
                                             (q, k, v), g), reps=10)
    n_x = _n_kind(cut, "xattn")
    print(f"[vision train] cross-attention sdpa ({B}, {Lq}) over ({B}, {Lk}), {H}/{KV} heads "
          f"of {dh}, f32 einsums in chunks of {rcfg.attn_chunk}: forward {fwd:.3f} ms, "
          f"checkpointed forward + recompute + backward {fb:.3f} ms; x{n_x} a step = "
          f"{n_x * fb:.1f} ms ({100 * n_x * fb / step_ms:.1f}% of the {step_ms:.1f} ms step) "
          f"(isolated, CUDA events) {tag}")
    del q, k, v, g
    torch.cuda.empty_cache()
    return n_x * fb


def phase_vision_training(smi):
    """llama-3.2-vision-11b at full width, cut to one unit (5 layers: 4
    attn, 1 xattn), gates filled with VIS_GATE, trained under attn.qkv and
    attn.cross_kv PAMM: f32 params / bf16 compute, AdamW, batch 4 x 2048
    with 4 x 1601 image tokens, remat VIS_REMAT; one warm-up and 3
    measured steps (finite losses; launches a step K1 6, K2 15, K3 = K4 =
    K5 4; telemetry; step and forward + backward peaks; a profiler split),
    forward + backward peaks exact, under attn.qkv alone and under both
    rules (the attn.cross_kv site's saving), and a second run from the
    seed. Returns the per-step launch counts and the record."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import RunConfig, get_config

    full = get_config(VIS_ARCH)
    cut = dataclasses.replace(full, stages=VIS_TRAIN_STAGES,
                              n_layers=sum(len(u) * r for u, r in VIS_TRAIN_STAGES))
    rcfg = RunConfig(compression=VIS_SPEC, policy_name="none", remat=VIS_REMAT)
    tag = f"[{smi}]"
    n = TRAIN_STEPS
    state, step_fn, rec = _train_run(cut, rcfg, n, measure=True)
    n_params = sum(p.numel() for p in state.params.parameters())
    per_step = {k: v / n for k, v in rec["counts"].items()}
    n_attn, n_x = _n_kind(cut, "attn"), _n_kind(cut, "xattn")
    print(f"[vision train] {VIS_ARCH} cut to {cut.n_layers} of {full.n_layers} layers "
          f"{VIS_TRAIN_STAGES}, gates {VIS_GATE}: {n_params / 1e9:.3f} B params f32, compute "
          f"{rcfg.compute_dtype}, {VIS_SPEC}, remat={VIS_REMAT!r}, AdamW, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} with {TRAIN_BATCH} x {VIS_TOKENS} image tokens; losses {rec['loss']} | "
          f"grad norms {[round(g, 4) for g in rec['gnorm']]}")
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
          "vision: a training loss or grad norm is not finite")
    # K1 once a site a layer: attn.qkv in every layer (the xattn layer's
    # over its text input, wq alone) and attn.cross_kv in each xattn
    # layer; K2 once a compressed weight: wq, wk, wv of each attn layer,
    # the xattn layer's wq, wk, wv; K3-K5 in the self-attention layers only
    want = {"csim_argmax": n_attn + 2 * n_x, "segment_matmul": 3 * n_attn + 3 * n_x,
            "flash_attention_fwd": (1 if VIS_REMAT == "none" else 2) * n_attn,
            "flash_attention_dq": n_attn, "flash_attention_dkv": n_attn,
            **{k: 0 for k in ATTN_KERNELS if k.endswith("_f32") or "decode" in k}}
    print(f"[vision train] launches per step {per_step} (K1: {n_attn} attn.qkv + {n_x} "
          f"xattn attn.qkv + {n_x} attn.cross_kv; K2: {n_attn} x wq, wk, wv + {n_x} x wq "
          f"(attn.qkv), wk, wv (attn.cross_kv); K3-K5: the {n_attn} self-attention layers)")
    check({k: per_step.get(k, 0) for k in want} == want
          and not any(k.endswith("_ref") for k in rec["counts"]),
          f"vision training launches per step {per_step} != {want}, or a plain version ran")
    step_ms = statistics.median(rec["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[vision train] {1e3 * tokens / step_ms:.1f} tokens/s | {step_ms:.1f} ms per step "
          f"(median of {n}: {[round(t, 1) for t in rec['ms'][1:]]}; warm-up step "
          f"{rec['ms'][0]:.1f} ms) | step peak torch.cuda.max_memory_allocated "
          f"{rec['peak'] / 2**30:.3f} GiB {tag}")
    sites = {k: round(v, 6) for k, v in rec["metrics"].items() if k.startswith("site/")}
    print(f"[vision train] site telemetry (summed over the layers) {sites}")
    trace_training_step(state, step_fn, cut, step_ms, n + 1, tag="vision ")
    rec["xattn_ms"] = _vision_hotspots(cut, rcfg, step_ms, tag)
    specs = (("exact", ""), ("attn.qkv", "attn.qkv=pamm(r=1/512)"), ("both", VIS_SPEC))
    peaks = {label: _fwd_bwd_peak(cut, dataclasses.replace(rcfg, compression=spec,
                                                           remat="none"), state, TRAIN_SEQ)
             for label, spec in specs}
    rec["fb_peak"], rec["fb_peaks"] = peaks["both"], peaks
    qkv, cross = peaks["exact"] - peaks["attn.qkv"], peaks["attn.qkv"] - peaks["both"]
    img_mib = TRAIN_BATCH * VIS_TOKENS * VIS_D * 2 / 2**20
    kv_mib = 2 * VIS_D * full.n_kv_heads * full.head_dim * 2 / 2**20
    print(f"[vision train] forward + backward peak (one loss_and_grad, AdamW moments "
          f"resident), remat='none': "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
          + f"; attn.qkv saves {qkv / 2**20:.1f} MiB ({n_attn + n_x} layers), attn.cross_kv "
          f"{cross / 2**20:.1f} MiB ({n_x} xattn layer; the shared bf16 image embeddings are "
          f"{img_mib:.1f} MiB, wk + wv's bf16 copies {kv_mib:.1f} MiB a layer) {tag}")
    del state, step_fn
    torch.cuda.empty_cache()
    _, _, rec2 = _train_run(cut, rcfg, n, measure=False)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec2["loss"], rec["loss"])]
    print(f"[vision train] second run from seed {rcfg.seed}: losses {rec2['loss']} (step 0 "
          f"equal: {rec2['loss'][0] == rec['loss'][0]}; later steps worst rel "
          f"{max(rel[1:]):.2e}, tol 1e-3)")
    check(rec2["loss"][0] == rec["loss"][0] and max(rel[1:]) <= 1e-3,
          "vision: a second run from the seed gives other losses")
    torch.cuda.empty_cache()
    return per_step, rec


def phase_vision_numbers(gen, serve, per_step, rec, smi, errs):
    """Kernel rows at llama-vision's shapes: K6 non-causal over the 1601
    image slots of 8 slots (SDPA non-causal over the same K / V, GQA
    expanded, as the library; launches: the paged serving run's K6, every
    one non-causal); K3, K4 and K5 at the training shape (4, 2048, 32 / 8,
    128) with SDPA as the library (launches: the vision training path's);
    K1 at the attn.cross_kv site's (6404, 4096, k 13) and K2 at b 6404, m
    1024 (launches: the vision training path's K1 / K2 of every site);
    then K3 at the serving prefill shape and K6 causal / K7 at the cell's
    decode shapes, printed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_ref

    tag = f"[{smi}]"
    launches = {k: int(round(v * TRAIN_STEPS)) for k, v in per_step.items()}
    H, KV, dh = VIS_HEADS
    B, S = SLOTS, VIS_TOKENS
    q, kc, vc, qpos, spos = cross_decode_inputs(gen, B, S, H, KV, dh)
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (kc, vc))
    qt = q.transpose(1, 2)
    paged = serve["paged"]
    rows = [_kernel_row(
        f"flash_decode (K6 non-causal, llama-vision's {S} image slots, {B} x {S}, {H}/{KV}, "
        f"{dh})", K6_SOURCE, K6_REPLACES, paged["counts"].get("flash_decode", 0),
        errs["K6 cross"],
        lambda: flash_decode_cuda(q, kc, vc, qpos, spos, causal=False),
        lambda: flash_decode_ref(q, kc, vc, qpos, spos, causal=False),
        lambda: F.scaled_dot_product_attention(qt, kx, vx),
        k6_work(qpos, spos, H, KV, dh, window=0, itemsize=2, causal=False))]
    del q, kc, vc, kx, vx
    at = f"({TRAIN_BATCH}, {TRAIN_SEQ}, {H}/{KV}, {dh})"
    att = attention_inputs(gen, TRAIN_BATCH, TRAIN_SEQ, H, KV, dh)
    for kern, name, source, replaces in (
            ("K3", "flash_attention_fwd", K3_SOURCE, K3_REPLACES),
            ("K4", "flash_attention_dq", K45_SOURCE, K4_REPLACES),
            ("K5", "flash_attention_dkv", K45_SOURCE, K5_REPLACES)):
        rows.append(_kernel_row(f"{name} ({kern}, llama-vision's self-attention heads, {at})",
                                source, replaces, launches.get(name, 0), errs[kern],
                                *att[kern]))
    del att
    torch.cuda.empty_cache()
    b, n, k, m = VIS_CROSS_B, VIS_D, VIS_CROSS_K, VIS_CROSS_M
    rows += site_k1_k2_rows(
        gen, b, n, k, "csim_argmax (K1, llama-vision's attn.cross_kv site)",
        [(m, "segment_matmul (K2, llama-vision's attn.cross_kv site: wk, wv)")],
        launches, errs)[0]
    train_note = f"launches on the vision training path ({TRAIN_STEPS} steps)"
    notes = ((f"launches in the paged vision serving run ({paged['stats']['decode_steps']} "
              f"steps, every one non-causal)", "q_pos 0"),
             (train_note, ""), (train_note, ""), (train_note, ""),
             (f"{train_note}, every site", f" at ({b}, {n}, k {k})"),
             (f"{train_note}, every site", f" at (b {b}, m {m}, k {k})"))
    print_rows(rows, notes, tag)
    dense = serve["dense"]["stats"]
    step_ms = 1e3 * dense["decode_s"] / max(1, dense["decode_steps"])
    n_x = _n_kind(serve_cfg(VIS_ARCH), "xattn")
    print(f"[numbers] vision dense decode step {step_ms:.2f} ms: K6 non-causal x{n_x} "
          f"{n_x * rows[0]['ms']:.3f} ms (isolated, L2 flushed) {tag}")
    line = functools.partial(timed_line, "llama-vision", tag)
    att = attention_inputs(gen, 1, PROMPT_LEN, H, KV, dh)
    line(f"K3 (1, {PROMPT_LEN}, {H}/{KV}, {dh})", *att["K3"],
         f"{serve['dense']['counts'].get('flash_attention_fwd', 0)} launches serving")
    del att
    cfg = serve_cfg(VIS_ARCH)                  # the dense run's K6 launches, causal ones only
    causal = {"counts": {"flash_decode": _n_kind(cfg, "attn") * dense["decode_steps"]},
              "stats": dense}
    decode_lines(gen, line, H, KV, dh, 0, {"dense": causal, "paged": paged})
    return rows


def run_vision_phases(gen, smi):
    """Phases 26-29: K6 non-causal and the attn.cross_kv site's K1 / K2
    against their plain versions, llama-3.2-vision-11b served at full width (5 layers)
    (gates filled), vision smoke card against CPU, the model trained at
    full width and a cut depth, the vision kernel rows. Returns the
    rows."""
    errs = phase_vision_kernels(gen)
    serve = phase_vision_serving(smi)
    phase_card_vs_cpu(VIS_SMOKE, VIS_SMOKE_SPEC)
    per_step, rec = phase_vision_training(smi)
    return phase_vision_numbers(gen, serve, per_step, rec, smi, errs)


# ---------------------------------------------------------------------------
# the audio slice: musicgen-medium, and the examples
# ---------------------------------------------------------------------------
def phase_audio_kernels(gen):
    """musicgen's kernels at its 24 / 24 heads of 64 (MHA, G 1), each
    against its plain version: K3 and K4/K5 (fed K3's o and lse) at the
    training shape (4, 2048) and K3 at the prefill shape (8, 1024), bf16,
    two launches of each bitwise equal; K6 over 8 slots x 1089 (row 3
    parked at -1), two launches and each row alone bitwise equal; K1 at the
    attn.qkv site's (8192, 1536, k 16) and K2 at b 8192, m 1536 (wq, wk,
    wv) and m 2048 (a codebook's head columns under a lm_head rule).
    Returns the largest errors."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda

    H, KV, dh = AUDIO_HEADS
    bf16 = torch.bfloat16
    errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    check_k3_k45(gen, TRAIN_BATCH, TRAIN_SEQ, H, KV, dh, 0, None, bf16, errs, repeat=True)
    q = _randn((SLOTS, PROMPT_LEN, H, dh), gen)
    kk, v = _randn((SLOTS, PROMPT_LEN, KV, dh), gen), _randn((SLOTS, PROMPT_LEN, KV, dh), gen)
    e, o, lse = check_k3(q, kk, v, window=0, label=", musicgen's prefill shape")
    again = flash_attention_fwd_cuda(q, kk, v, causal=True, window=0)
    check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
          "two launches of K3 give other bits at musicgen's prefill shape")
    print("[K3] musicgen's prefill shape: two launches bitwise equal")
    errs["K3"] = max(errs["K3"], e)
    del q, kk, v, o, lse, again
    errs["K6"] = check_k6(gen, SLOTS, MAX_LEN, H, KV, dh, ring=False)
    errs["K1"], f = check_site_k1(gen, TRAIN_BATCH * TRAIN_SEQ, AUDIO_D, AUDIO_K, "attn.qkv")
    errs["K2"] = max(check_site_k2(gen, f, m, AUDIO_K, "attn.qkv" if m == AUDIO_D else "lm_head")
                     for m in AUDIO_M)
    torch.cuda.empty_cache()
    return errs


def phase_audio_decode(smi):
    """musicgen-medium at full size, bf16, random weights from seed 0,
    scored over embeddings: 8 rows of PROMPT_LEN + 8 embeddings from the
    stream; one batched prefill over the first PROMPT_LEN (cache MAX_LEN),
    then AUDIO_DECODE_STEPS decode_steps each fed the next embedding (B, 1,
    d); each step's logits (B, 1, 4 x 2048) against the full forward's at
    the same position within TOL_AUDIO_DECODE of the row's largest |logit|.
    Launches of the prefill and the steps: K3 = 48 x prefills, K6 = 48 x
    steps, nothing else. A profiler split of one prefill and one decode
    step. Returns the record."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.keys import Key
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import launches
    from repro_torch.models import decode_step, forward, init_model, prefill

    tag = f"[{smi}]"
    cfg = get_config(AUDIO_ARCH)
    rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
    t0 = time.perf_counter()
    model = init_model(cfg, rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n = AUDIO_DECODE_STEPS
    embeds = torch.from_numpy(SyntheticStream.for_arch(cfg, PROMPT_LEN + n, SLOTS)
                              .get_batch(0)["embeds"]).to("cuda")
    print(f"[audio decode] {AUDIO_ARCH}: {n_params / 1e9:.3f} B params (bf16; no embed "
          f"table, head {tuple(model.head.shape)}), {cfg.n_layers} layers, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_codebooks} codebooks of "
          f"{cfg.vocab_size}; initialised on the card in {time.perf_counter() - t0:.1f} s; "
          f"embeddings {tuple(embeds.shape)} from the stream")
    steps = [(embeds[:, PROMPT_LEN + i:PROMPT_LEN + i + 1],
              torch.full((SLOTS, 1), PROMPT_LEN + i, dtype=torch.int32, device="cuda"))
             for i in range(n)]
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, rcfg, model, {"embeds": embeds[:, :PROMPT_LEN]}, MAX_LEN)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    got, step_ms = [logits], []
    for x, pos in steps:
        t0 = time.perf_counter()
        lg, caches = decode_step(cfg, rcfg, model, x, pos, caches)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        got.append(lg)
    counts = launches.counts()
    want = {"flash_attention_fwd": cfg.n_layers, "flash_decode": cfg.n_layers * n}
    print(f"[audio decode] launches {counts} (K3 = {cfg.n_layers} x 1 prefill, K6 = "
          f"{cfg.n_layers} x {n} decode steps)")
    check(counts == want, f"audio decode launches {counts} != {want}")
    with torch.no_grad():
        h, _ = forward(cfg, rcfg, "", model, {"embeds": embeds}, Key(0))
        full = (h[:, PROMPT_LEN - 1:] @ model.head.to(h.dtype)).float()
    del h
    errs = []
    for i, lg in enumerate(got):
        check(lg.shape == (SLOTS, 1, cfg.n_codebooks * cfg.vocab_size)
              and bool(lg.isfinite().all()), f"audio decode: logits {i} bad shape or not finite")
        ref = full[:, i]
        errs.append(((lg[:, 0] - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item())
    print(f"[audio decode] logits (B, 1, {cfg.n_codebooks * cfg.vocab_size}) against the full "
          f"forward over {PROMPT_LEN + n} embeddings at the same position, worst |diff| of "
          f"the row's max |logit| (mean {full.abs().amax(-1).mean().item():.3f}): prefill "
          f"{errs[0]:.3e}, decode steps {[f'{e:.3e}' for e in errs[1:]]} (tol "
          f"{TOL_AUDIO_DECODE})")
    check(max(errs) <= TOL_AUDIO_DECODE, "audio decode logits disagree with the full forward")
    step = statistics.median(step_ms)
    print(f"[audio decode] prefill {SLOTS} x {PROMPT_LEN}: {prefill_ms:.1f} ms "
          f"({1e3 * SLOTS * PROMPT_LEN / prefill_ms:.0f} tok/s, the first call) | decode step "
          f"median {step:.2f} ms ({1e3 * SLOTS / step:.1f} tok/s), steps "
          f"{[round(t, 2) for t in step_ms]} | memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB {tag}")
    x, pos = steps[0]
    base = {}
    for label, work in (("prefill", lambda: prefill(cfg, rcfg, model,
                                                    {"embeds": embeds[:, :PROMPT_LEN]},
                                                    MAX_LEN)),
                        ("decode step", lambda: decode_step(cfg, rcfg, model, x, pos, caches))):
        work()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        base[label] = 1e3 * (time.perf_counter() - t0)
        profile_split(label, work, base[label], tag="audio ")
    del model, caches, embeds, full, got
    torch.cuda.empty_cache()
    return {"counts": counts, "steps": n, "prefill_ms": prefill_ms, "step_ms": step,
            "errs": errs}


def phase_audio_training(smi):
    """musicgen-medium_smoke in f32, card against CPU, under attn.qkv PAMM
    and with a lm_head rule added (K1 / K2 once a codebook and loss
    chunk); then musicgen-medium at full width and depth, f32 params /
    bf16 compute, attn.qkv=pamm(r=1/512), remat AUDIO_REMAT, AdamW, batch 4
    x 2048 embeddings with four-codebook labels: one warm-up and 3
    measured steps (finite losses; launches a step K1 48, K2 144, K3 96,
    K4 = K5 48, f32 routes and plain versions 0; telemetry; step and
    forward + backward peaks; a profiler split), forward + backward under
    remat='none' at AUDIO_CUT_LAYERS layers with and without the rule (the
    site's saving a layer), and a second run from the seed. Returns the
    per-step launch counts and the record."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.train import init_train_state

    smoke = get_config(AUDIO_SMOKE)
    for spec in AUDIO_SMOKE_SPECS:
        # one loss chunk of 64 tokens (loss_chunk 1024): a lm_head rule adds
        # one K1 and one K2 a codebook
        head = smoke.n_codebooks if "lm_head" in spec else 0
        phase_card_vs_cpu(AUDIO_SMOKE, spec, {
            "csim_argmax": smoke.n_layers + head,
            "segment_matmul": 3 * smoke.n_layers + head,
            "flash_attention_fwd_f32": smoke.n_layers, "flash_attention_dq_f32": smoke.n_layers,
            "flash_attention_dkv_f32": smoke.n_layers})
    cfg = get_config(AUDIO_ARCH)
    rcfg = RunConfig(compression=AUDIO_SPEC, policy_name="none", remat=AUDIO_REMAT)
    tag = f"[{smi}]"
    n = TRAIN_STEPS
    state, step_fn, rec = _train_run(cfg, rcfg, n, measure=True)
    n_params = sum(p.numel() for p in state.params.parameters())
    per_step = {k: v / n for k, v in rec["counts"].items()}
    print(f"[audio train] {AUDIO_ARCH}: {n_params / 1e9:.3f} B params f32 (no embed table), "
          f"compute {rcfg.compute_dtype}, {AUDIO_SPEC}, remat={AUDIO_REMAT!r}, AdamW, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} embeddings, labels of {cfg.n_codebooks} codebooks; "
          f"losses {rec['loss']} | grad norms {[round(g, 4) for g in rec['gnorm']]}")
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
          "audio: a training loss or grad norm is not finite")
    L = cfg.n_layers
    # K1 once a layer (remat='pamm' keeps the states across the recompute),
    # K2 for wq, wk, wv, K3 in the forward and the recompute
    want = {"csim_argmax": L, "segment_matmul": 3 * L, "flash_attention_fwd": 2 * L,
            "flash_attention_dq": L, "flash_attention_dkv": L,
            **{k: 0 for k in ATTN_KERNELS if k.endswith("_f32") or "decode" in k}}
    print(f"[audio train] launches per step {per_step}")
    check({k: per_step.get(k, 0) for k in want} == want
          and not any(k.endswith("_ref") for k in rec["counts"]),
          f"audio training launches per step {per_step} != {want}, or a plain version ran")
    step_ms = statistics.median(rec["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[audio train] {1e3 * tokens / step_ms:.1f} tokens/s | {step_ms:.1f} ms per step "
          f"(median of {n}: {[round(t, 1) for t in rec['ms'][1:]]}; warm-up step "
          f"{rec['ms'][0]:.1f} ms) | step peak torch.cuda.max_memory_allocated "
          f"{rec['peak'] / 2**30:.3f} GiB {tag}")
    sites = {k: round(v, 6) for k, v in rec["metrics"].items() if k.startswith("site/")}
    print(f"[audio train] site telemetry (summed over {L} layers) {sites}")
    trace_training_step(state, step_fn, cfg, step_ms, n + 1, tag="audio ")
    rec["fb_peak"] = _fwd_bwd_peak(cfg, rcfg, state, TRAIN_SEQ)
    print(f"[audio train] forward + backward peak (one loss_and_grad, AdamW moments "
          f"resident) {rec['fb_peak'] / 2**30:.3f} GiB {tag}")
    del state, step_fn
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, stages=((("attn",), AUDIO_CUT_LAYERS),),
                              n_layers=AUDIO_CUT_LAYERS)
    state = init_train_state(cut, rcfg, device="cuda")
    peaks = {label: _fwd_bwd_peak(cut, dataclasses.replace(rcfg, compression=spec,
                                                           remat="none"), state, TRAIN_SEQ)
             for label, spec in (("attn.qkv exact", "attn.qkv=none"), (AUDIO_SPEC, AUDIO_SPEC))}
    saved = peaks["attn.qkv exact"] - peaks[AUDIO_SPEC]
    rec["cut_peaks"], rec["saved_per_layer"] = peaks, saved / AUDIO_CUT_LAYERS
    x_mib = tokens * AUDIO_D * 2 / 2**20
    w_mib = 3 * AUDIO_D * AUDIO_D * 2 / 2**20
    print(f"[audio train] cut to {AUDIO_CUT_LAYERS} of {L} layers, remat='none', batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: forward + backward peak "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
          + f"; the attn.qkv site saves {saved / 2**20:.1f} MiB ({saved / 2**20 / AUDIO_CUT_LAYERS:.2f}"
          f" MiB a layer; its bf16 input is {x_mib:.1f} MiB a layer, wq + wk + wv's bf16 "
          f"copies {w_mib:.1f} MiB) {tag}")
    del state
    torch.cuda.empty_cache()
    _, _, rec2 = _train_run(cfg, rcfg, n, measure=False)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec2["loss"], rec["loss"])]
    print(f"[audio train] second run from seed {rcfg.seed}: losses {rec2['loss']} (step 0 "
          f"equal: {rec2['loss'][0] == rec['loss'][0]}; later steps worst rel "
          f"{max(rel[1:]):.2e}, tol 1e-3)")
    check(rec2["loss"][0] == rec["loss"][0] and max(rel[1:]) <= 1e-3,
          "audio: a second run from the seed gives other losses")
    torch.cuda.empty_cache()
    return per_step, rec


def _launched(counts: dict, kernels) -> dict:
    """Launches of each kernel id in ``kernels``, its routes summed."""
    return {k: sum(counts.get(name, 0) for name in EXAMPLE_KERNELS[k]) for k in kernels}


def phase_example_kernels(gen):
    """The examples' kernels at the shapes and types their paths give them,
    each against its plain version. llama-tiny (4 layers, d 128, 4 / 4
    heads of 32) over 8 x 64 tokens: one f32 train step, card against CPU,
    under quickstart's spec and under finetune_compare's PAMM at each of its
    ratios (K1-K5 on the f32 routes, launches a loss and backward K1 4, K2
    12, K3 = K4 = K5 4); at pretrain's bf16 compute, K3 with K4/K5 at (8,
    64, 4 / 4, 32), K1 at (512, 128, k) and K2 at m 128 (wq, wk, wv), two
    launches bitwise equal. serve_batched's internlm2-1.8b_smoke in f32 (its
    CLI's default): K3 over its 32-token prompt bucket and K6 over its 4
    slots of 49, at 4 / 2 heads of 16."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.pamm import num_generators
    from repro_torch.core.plan import plan_spec_from_legacy
    from repro_torch.examples import finetune_compare, pretrain, quickstart

    cfg = get_config(EXAMPLE_ARCH)
    L, H, KV, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f32 = {"csim_argmax": L, "segment_matmul": 3 * L, "flash_attention_fwd_f32": L,
           "flash_attention_dq_f32": L, "flash_attention_dkv_f32": L}
    for div in finetune_compare.DIVISORS:
        phase_card_vs_cpu(EXAMPLE_ARCH, plan_spec_from_legacy(RunConfig(pamm_ratio=1 / div)),
                          f32, batch=EXAMPLE_BATCH)
    phase_card_vs_cpu(EXAMPLE_ARCH, quickstart.COMPRESSION, f32, batch=EXAMPLE_BATCH)
    b, bf16 = EXAMPLE_BATCH * EXAMPLE_SEQ, torch.bfloat16
    errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    check_k3_k45(gen, EXAMPLE_BATCH, EXAMPLE_SEQ, H, KV, dh, 0, None, bf16, errs, repeat=True)
    k = num_generators(b, 1 / pretrain.RATIO)
    _, f = check_site_k1(gen, b, cfg.d_model, k, "pretrain's attn.qkv")
    check_site_k2(gen, f, H * dh, k, "pretrain's attn.qkv")
    serve = get_config(EXAMPLE_SERVE_ARCH)
    H, KV, dh = serve.n_heads, serve.n_kv_heads, serve.head_dim
    q = _randn((1, EXAMPLE_PROMPT, H, dh), gen, torch.float32)
    kk, v = (_randn((1, EXAMPLE_PROMPT, KV, dh), gen, torch.float32) for _ in range(2))
    check_k3(q, kk, v, window=0, label=", serve_batched's prompt bucket")
    check_k6(gen, EXAMPLE_SLOTS, EXAMPLE_CACHE, H, KV, dh, ring=False, step=11,
             dtype=torch.float32)


def phase_examples(gen, smi):
    """The examples' kernels against their plain versions at the examples'
    shapes (phase_example_kernels); then the port's examples on the card
    through their main(), with no --device (the default is the card):
    quickstart (its first loss finite and its last below it), serve_batched
    on internlm2-1.8b_smoke, pretrain for 20 steps with a checkpoint in a
    temporary directory and again for 24 (it resumes at step 20),
    finetune_compare at 20 / 10 steps. Each must return, print finite
    losses or perplexities and launch the card's kernels (K1-K5 in
    training, K3 and K6 in serving), no plain version."""
    import contextlib
    import io
    import math
    import tempfile

    import torch

    from repro_torch.examples import finetune_compare, pretrain, quickstart, serve_batched
    from repro_torch.kernels import launches

    phase_example_kernels(gen)
    tag = f"[{smi}]"
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    train_k = ("K1", "K2", "K3", "K4", "K5")
    with tempfile.TemporaryDirectory(dir=build) as ckpt:
        runs = (("quickstart", quickstart.main, [], train_k),
                ("serve_batched", serve_batched.main, ["--arch", EXAMPLE_SERVE_ARCH],
                 ("K3", "K6")),
                ("pretrain", pretrain.main, ["--steps", "20", "--ckpt", ckpt], train_k),
                ("pretrain resumed", pretrain.main, ["--steps", "24", "--ckpt", ckpt],
                 train_k),
                ("finetune_compare", finetune_compare.main,
                 ["--pretrain-steps", "20", "--finetune-steps", "10"], train_k))
        for name, main_fn, argv, kernels in runs:
            launches.reset()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                main_fn(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out = buf.getvalue().splitlines()
            counts = launches.counts()
            ran = _launched(counts, kernels)
            print(f"[examples] {name} {' '.join(argv)}: returned in {wall:.1f} s; kernels "
                  f"launched {ran}; output: " + " // ".join(out[-4:]) + f" {tag}")
            check(all(ran.values()) and not any(k.endswith("_ref") for k in counts),
                  f"{name}: the card's kernels did not all run ({counts})")
            if name == "quickstart":
                losses = [float(line.split()[-1]) for line in out if line.startswith("step ")]
                check(len(losses) == 5 and all(math.isfinite(x) for x in losses)
                      and losses[-1] < losses[0],
                      f"quickstart: losses {losses} not finite or not falling")
                check(out[-1].startswith("[pamm] QKV activations over 4 layers"),
                      "quickstart: no activation report")
            elif name == "serve_batched":
                check(sum("finish=length" in line for line in out) == 8,
                      "serve_batched: a request did not finish")
            elif name.startswith("pretrain"):
                done = [line for line in out if line.startswith("done:")]
                steps = "completed_steps=20" if name == "pretrain" else "completed_steps=4"
                check(len(done) == 1 and steps in " ".join(out)
                      and math.isfinite(float(done[0].split("final loss ")[1].split(",")[0])),
                      f"{name}: no finite final loss or not {steps}")
            else:
                ppl = [float(line.split()[-2]) for line in out[-3:]]
                check(all(math.isfinite(p) for p in ppl), f"finetune_compare: ppl {ppl}")


def phase_audio_numbers(gen, decode, per_step, rec, smi, errs):
    """Kernel rows at musicgen's shapes: K3, K4 and K5 at the training
    shape (4, 2048, 24 / 24, 64) with SDPA as the library (launches: the
    musicgen training path's); K6 over 8 slots x 1089 at 24 / 24 heads of
    64, mid-decode (SDPA with the slot mask as the library; launches: the
    decode phase's); K1 at the attn.qkv site's (8192, 1536, k 16) and K2 at
    b 8192, m 1536 (launches: the training path's); then K3 at the
    prefill shape (8, 1024) and K2 at m 2048 (a lm_head rule's codebook
    columns), printed."""
    import torch

    from repro_torch.kernels.pamm_apply import segment_matmul_cuda, segment_matmul_ref

    tag = f"[{smi}]"
    launches = {k: int(round(v * TRAIN_STEPS)) for k, v in per_step.items()}
    H, KV, dh = AUDIO_HEADS
    at = f"({TRAIN_BATCH}, {TRAIN_SEQ}, {H}/{KV}, {dh})"
    att = attention_inputs(gen, TRAIN_BATCH, TRAIN_SEQ, H, KV, dh)
    rows = [_kernel_row(f"{name} ({kern}, musicgen's heads, {at})", source, replaces,
                        launches.get(name, 0), errs[kern], *att[kern])
            for kern, name, source, replaces in (
                ("K3", "flash_attention_fwd", K3_SOURCE, K3_REPLACES),
                ("K4", "flash_attention_dq", K45_SOURCE, K4_REPLACES),
                ("K5", "flash_attention_dkv", K45_SOURCE, K5_REPLACES))]
    del att
    B, S = SLOTS, MAX_LEN
    rows.append(_kernel_row(
        f"flash_decode (K6, musicgen's heads, {B} x {S}, {H}/{KV}, {dh})", K6_SOURCE,
        K6_REPLACES, decode["counts"].get("flash_decode", 0), errs["K6"],
        *k6_inputs(gen, H, KV, dh, PROMPT_LEN + AUDIO_DECODE_STEPS // 2)))
    b, n, k, m = TRAIN_BATCH * TRAIN_SEQ, AUDIO_D, AUDIO_K, AUDIO_M[0]
    site_rows, (f, alpha) = site_k1_k2_rows(
        gen, b, n, k, "csim_argmax (K1, musicgen's attn.qkv site)",
        [(m, "segment_matmul (K2, musicgen's attn.qkv site: wq, wk, wv)")], launches, errs)
    rows += site_rows
    train_note = f"launches on the musicgen training path ({TRAIN_STEPS} steps)"
    notes = ((train_note, ""), (train_note, ""), (train_note, ""),
             (f"launches in the audio decode phase ({decode['steps']} steps)",
              f" q_pos {PROMPT_LEN + AUDIO_DECODE_STEPS // 2}"),
             (train_note, f" at ({b}, {n}, k {k})"), (train_note, f" at (b {b}, m {m}, k {k})"))
    print_rows(rows, notes, tag)
    line = functools.partial(timed_line, "musicgen", tag)
    gz2 = _randn((b, AUDIO_M[1]), gen)
    line(f"K2 (b {b}, m {AUDIO_M[1]}, k {k}: a lm_head rule's codebook columns)",
         lambda: segment_matmul_cuda(f, alpha, gz2, k),
         lambda: segment_matmul_ref(f, alpha, gz2, k), None, k2_work(b, AUDIO_M[1], k, 2),
         "0 launches on the musicgen training path (no lm_head rule there)")
    del gz2
    att = attention_inputs(gen, SLOTS, PROMPT_LEN, H, KV, dh)
    line(f"K3 ({SLOTS}, {PROMPT_LEN}, {H}/{KV}, {dh})", *att["K3"],
         f"{decode['counts'].get('flash_attention_fwd', 0)} launches in the audio prefill")
    del att
    step_ms = statistics.median(rec["ms"][1:])
    L = int(per_step.get("csim_argmax", 0))
    k3, k4, k5, k6, k1, k2 = rows
    print(f"[numbers] musicgen train step {step_ms:.1f} ms: K3 x{2 * L} "
          f"{2 * L * k3['ms']:.1f} ms, K4 x{L} {L * k4['ms']:.1f} ms, K5 x{L} "
          f"{L * k5['ms']:.1f} ms, K1 x{L} {L * k1['ms']:.2f} ms, K2 x{3 * L} "
          f"{3 * L * k2['ms']:.2f} ms (isolated, L2 flushed); decode step "
          f"{decode['step_ms']:.2f} ms: K6 x{L} {L * k6['ms']:.2f} ms {tag}")
    torch.cuda.empty_cache()
    return rows


def run_audio_phases(gen, smi):
    """Phases 30-34: musicgen's kernels against their plain versions,
    musicgen-medium scored and decoded over embeddings at full size,
    musicgen smoke card against CPU and musicgen-medium trained at full
    size, the examples on the card, the audio kernel rows. Returns the
    rows."""
    errs = phase_audio_kernels(gen)
    decode = phase_audio_decode(smi)
    per_step, rec = phase_audio_training(smi)
    phase_examples(gen, smi)
    return phase_audio_numbers(gen, decode, per_step, rec, smi, errs)


# ---------------------------------------------------------------------------
# the mesh slice: data x context training over gloo ranks on one card
# ---------------------------------------------------------------------------
MESH_SPEC = TRAIN_SPEC
MESH_REMAT = "pamm"
# step indices 1 and 2: the warmup-cosine rate is 0 at index 0, so both
# mesh steps update the parameters
MESH_STEPS, MESH_TOTAL = (1, 2), 10
RING_CP, RING_B, RING_C = 2, 2, 1024          # the context phase's chunk: 4096 / (2 cp)
RING_WINDOW = 1536                           # more than a chunk: crosses a zigzag seam
DATA_SHAPE, DATA_BATCH, DATA_SEQ = (2, 1), 4, 2048
CTX_SHAPE, CTX_BATCH, CTX_SEQ = (1, 2), 2, 4096
DC_SHAPE, DC_BATCH, DC_SEQ, DC_LAYERS = (2, 2), 4, 4096, 4
# phases 36-37 at full width cut to 4 of 24 layers: at full depth they took
# 136 s of an 880 s script, and the whole script passed 1200 s on a slower
# host; the tensor-parallel phases keep full depth
MESH_LAYERS = 4
MESH_TIMEOUT = 600.0
SHARED = "ranks sharing one H100 over gloo"
# bf16 compute: the ranks' products run at other batch shapes (and the
# ring merges per chunk pair in f32), so activations differ in the last
# bf16 bits; a mean over >= 8192 tokens moves by far less than one bf16
# rounding (3.9e-3 relative)
TOL_MESH_LOSS = 2e-3
# data 2: the parameters' change over the two steps, ||mesh - single|| /
# ||single|| over every element (an H100 reads 1.05e-2). Adam moves nearly
# every element by about lr a step whatever the gradient's size, so the
# change is held, not the parameters (two runs from one start differ by at
# most ~4 lr anyway). A rank whose other half of a ZeRO-1 leaf stayed
# stale reads ~0.7, no update 1, reversed updates 2 (tools/mesh_phases.py
# --plant-fault shows the first)
TOL_MESH_UPDATE = 0.05
# context 2 and data 2 x context 2: the gradients of step 1 (at the
# initial parameters, after the all-reduce) of every leaf the attn.qkv
# site does not compress, ||mesh - single|| / ||single|| over their
# elements: the ring's backward (K4 / K5 on the merged lse, dk / dv home,
# dO zeroed on dead rows) and the context all-reduce, held to the
# single-process backward (an H100 reads 2.0e-2 at context 2, 1.3e-2 at
# data 2 x context 2). The compressed leaves draw other generator rows on
# the shards and are printed only
TOL_MESH_GRAD = 0.05
PAMM_LEAVES = ("attn.wq", "attn.wk", "attn.wv")     # the attn.qkv site's weights
# int8_ef: a leaf's residue after step 2 against ef_quantize(g + e) of the
# rank's own step-2 gradient g and its step-1 residue e, relative to
# ||e||: error feedback adds e back (without it the residue parts by about
# ||e||, which must be at least EF_NO_FEEDBACK away); and the ranks' mean
# of g + e - new residue (what each sent) against the one-leaf compressed
# all-reduce
EF_LEAF = "stages.0.0.attn.wo"
TOL_EF_RESIDUE, EF_NO_FEEDBACK, TOL_EF_MEAN = 1e-2, 0.5, 1e-5
# int8_ef against uncompressed: its first step starts from a zero residue,
# and int8 with one scale a tensor rounds every element under max / 254 to
# zero -- most of the sparse embedding gradient, which Adam then leaves
# unmoved -- until error feedback returns them in later steps; over two
# steps it must keep at least half the uncompressed run's loss decrease
# (tests/test_multidevice.py's 0.08 is a bound after 16 steps of
# llama-tiny, which this run at 2 steps of internlm2-1.8b did not meet)
TOL_EF_SHARE = 0.5
# the offset variants of the TPU kernels that the ring runs
K3_OFFS_REPLACES = "src/repro/kernels/flash_attention.py:313"
K4_OFFS_REPLACES = "src/repro/kernels/flash_attention.py:371"
K5_OFFS_REPLACES = "src/repro/kernels/flash_attention.py:421"
RING_PAIRS = ((0, 0), (2 * RING_C, RING_C), (3 * RING_C, 2 * RING_C), (3 * RING_C, RING_C))


def mesh_cfg(layers=None):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, stages=((("attn",), layers),), n_layers=layers)
    return cfg


def mesh_want_launches(cfg, cp: int) -> dict:
    """Launches a mesh step makes on each rank under remat='pamm': K1 once
    and K2 three times a layer; K3 in the forward and again in the
    recompute, K4 and K5 once, each over every live chunk pair (2cp + 1
    per rank with no window; 1 without a ring)."""
    pairs = 2 * cp + 1 if cp > 1 else 1
    n = cfg.n_layers
    return {"csim_argmax": n, "segment_matmul": 3 * n, "flash_attention_fwd": 2 * pairs * n,
            "flash_attention_dq": pairs * n, "flash_attention_dkv": pairs * n}


def phase_ring_kernels(gen):
    """Phase 35: K3 and K4/K5 against their plain versions at the ring's
    chunk shape (B 2, C 1024, 16 / 8 heads of 128), with the zigzag
    offsets of four chunk pairs of cp 2 (a diagonal, an adjacent pair
    across a seam, two past pairs), with no window and with a window of
    1536 that crosses a seam (rows of the (3C, C) pair then see no key),
    in bf16 and f32, check_k3's tolerances."""
    import torch

    errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for window in (0, RING_WINDOW):
            for offs in RING_PAIRS:
                check_k3_k45(gen, RING_B, RING_C, 16, 8, 128, window, offs, dtype, errs)
    torch.cuda.empty_cache()
    return errs


def _state_bytes(state) -> dict:
    return {"params": sum(p.numel() * p.element_size() for p in state.params.parameters()),
            "moments": sum(t.numel() * t.element_size()
                           for t in list(state.opt.m.values()) + list(state.opt.v.values())),
            "ef": sum(t.numel() * t.element_size() for t in (state.ef or {}).values())}


def _mesh_steps(step_fn, state, batches, comm=None, rec=None) -> tuple:
    """Run the steps, each timed on the host's clock around a synchronised
    step, its launches counted from 0 and its peak and card <-> host bytes
    read (appended to ``rec`` when given)."""
    import torch

    from repro_torch.kernels import launches

    if rec is None:
        rec = {"loss": [], "gnorm": [], "ms": [], "peak": [], "counts": [], "host": []}
    for s, batch in batches.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        if comm is not None:
            comm.reset()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, s)
        rec["loss"].append(float(m["loss"]))
        rec["gnorm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["peak"].append(torch.cuda.max_memory_allocated())
        rec["counts"].append(launches.counts())
        rec["host"].append({} if comm is None else dict(comm.host_bytes))
    return state, rec


def _warm_up() -> float:
    """One train step of internlm2-1.8b_smoke on the card: loads the
    kernels a step touches, so a rank that waits while rank 0 runs the
    single-process step starts the mesh warm. Returns its seconds."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.train import init_train_state, make_train_step

    t0 = time.perf_counter()
    cfg = get_config("internlm2-1.8b_smoke")
    rcfg = RunConfig(compression="attn.qkv=pamm(r=1/8)", policy_name="none",
                     remat=MESH_REMAT)
    state = init_train_state(cfg, rcfg, device="cuda")
    step = make_train_step(cfg, rcfg, total_steps=2)
    float(step(state, SyntheticStream.for_arch(cfg, 64, 4).get_batch(0), 1)[1]["loss"])
    del state
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _host_params(model) -> dict:
    import torch

    return {n: p.detach().to("cpu", torch.float32, copy=True)
            for n, p in model.named_parameters()}


def _single_grads(cfg, rcfg, model, batch, step: int) -> dict:
    """The single-process step's gradients at ``model``'s parameters on
    the GLOBAL ``batch``, on the host: its plan, its key
    (``Key(seed).fold_in(step)``) and ``loss_and_grad``, as
    ``make_train_step`` runs them."""
    from repro_torch.core.keys import Key
    from repro_torch.core.plan import resolve_for_run
    from repro_torch.train import loss_and_grad
    from repro_torch.train.train_step import batch_to_device

    _, _, grads = loss_and_grad(cfg, rcfg, resolve_for_run(cfg, rcfg), model,
                                batch_to_device(batch, model.device),
                                Key(rcfg.seed).fold_in(step))
    return {n: g.float().cpu() for n, g in grads.items()}


def _rel_by_leaf(pairs) -> dict:
    """``(name, a, ref)`` on the card -> {name: (||a - ref||^2, ||ref||^2)}."""
    import torch

    norm2 = lambda t: float(torch.linalg.vector_norm(t)) ** 2
    return {n: (norm2(a - ref), norm2(ref)) for n, a, ref in pairs}


def _rel_summary(parts: dict, keep=lambda n: True) -> dict:
    """The relative norm over the kept leaves' elements, and the worst
    kept leaf's."""
    kept = {n: v for n, v in parts.items() if keep(n)}
    num, den = (sum(v[i] for v in kept.values()) for i in (0, 1))
    worst = max(kept, key=lambda n: kept[n][0] / max(kept[n][1], 1e-300))
    return {"rel": (num / den) ** 0.5, "worst": worst,
            "worst_rel": (kept[worst][0] / max(kept[worst][1], 1e-300)) ** 0.5,
            "leaves": len(kept)}


def _grad_hook(ref: dict, out: dict):
    """A ``grads_hook`` for rank 0's mesh step: the gradients after the
    all-reduce against the single-process ones (``ref``, on the host), the
    leaves attn.qkv compresses and the others apart, into
    ``out["grad_cmp"]`` with the hook's own ms (inside the step's)."""
    import torch

    def hook(grads):
        t0 = time.perf_counter()
        parts = _rel_by_leaf((n, g.float(), ref[n].to(g.device)) for n, g in grads.items())
        pamm = lambda n: n.endswith(PAMM_LEAVES)
        torch.cuda.synchronize()
        out["grad_cmp"] = {"other": _rel_summary(parts, lambda n: not pamm(n)),
                           "pamm": _rel_summary(parts, pamm),
                           "ms": 1e3 * (time.perf_counter() - t0)}

    return hook


def _ef_probe(grads_fn, state, batch, step: int):
    """Before int8_ef's step ``step``: this rank's own (unreduced) gradient
    of EF_LEAF at the step's parameters and batch, and the leaf's residue
    so far, both cloned."""
    import torch

    _, _, grads = grads_fn.rank_grads(state.params, batch, step)
    g = grads[EF_LEAF].detach().float().clone()
    del grads
    torch.cuda.empty_cache()
    return g, state.ef[EF_LEAF].clone()


def _ef_check(grads_fn, mesh, g, e_old, e_new) -> dict:
    """The residue the step left against error feedback's rule, and the
    ranks' mean of what they sent against the compressed all-reduce."""
    from repro_torch.runtime.collectives import all_reduce_
    from repro_torch.runtime.grad_compress import ef_quantize

    norm = float(e_old.double().norm())
    rel = lambda a, b: float((a - b).double().norm()) / norm
    fb = rel(e_new, ef_quantize(g, e_old)[2])
    no_fb = rel(e_new, ef_quantize(g, e_old * 0)[2])
    sent = g + e_old - e_new
    n = mesh.size
    all_reduce_([sent], mesh.sync_group, n, mesh.comm, mean=True)
    mean, _ = grads_fn.sync_grads({EF_LEAF: g.clone()}, {EF_LEAF: e_old.clone()})
    mean = mean[EF_LEAF]
    return {"residue_rel": fb, "no_feedback_rel": no_fb, "residue_norm": norm,
            "mean_rel": float((sent - mean).double().norm() / mean.double().norm())}


def mesh_rank(rank: int, world: int, jobs: list) -> list:
    """One gloo rank of phases 36-38 (``launch.ranks`` starts it), every
    rank on cuda:0, running ``jobs`` in turn, each on its own mesh. For
    each job rank 0 first runs the single-process step on the whole global
    batch with blocks = the shard count (the others wait at a barrier,
    warming up before the first job) and keeps its losses and peak, and on
    the host what the job compares: the parameters' change over the steps
    (``compare="updates"``) or the first step's gradients (``"grads"``,
    which rank 0's mesh step then holds its own to through a
    ``grads_hook``); then every rank runs the mesh executor from the same
    seed and, with ``ef``, again under int8_ef, its own gradient of one
    leaf recomputed before the second step (``make_shard_map_grads``) to
    check the residue that step leaves."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import RunConfig
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import (init_distributed_state, init_train_state,
                                   make_shard_map_train_step, make_train_step)
    from repro_torch.train.distributed import make_shard_map_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()                       # the parent's builds, found by their hashes
    outs = []
    for i, job in enumerate(jobs):
        cfg = mesh_cfg(job["layers"])
        data, ctx = job["shape"]
        rcfg = RunConfig(compression=MESH_SPEC, policy_name="none", remat=MESH_REMAT)
        stream = SyntheticStream.for_arch(cfg, job["seq"], job["batch"], seed=rcfg.seed)
        steps = MESH_STEPS[:job["steps"]]
        batches = {s: stream.get_batch(s) for s in steps}
        mesh = make_debug_mesh(data, 1, ctx, timeout=MESH_TIMEOUT)
        out = {"rank": rank}
        ref = {}
        if rank == 0:
            blocked = dataclasses.replace(rcfg,
                                          compression=f"{MESH_SPEC[:-1]},blocks={world})")
            state = init_train_state(cfg, blocked, device="cuda")
            if job["compare"] == "updates":
                ref["p0"] = _host_params(state.params)
            else:
                ref["grads"] = _single_grads(cfg, blocked, state.params, batches[steps[0]],
                                             steps[0])
            state, out["single"] = _mesh_steps(make_train_step(cfg, blocked,
                                                               total_steps=MESH_TOTAL),
                                               state, batches)
            out["single_bytes"] = _state_bytes(state)
            out["single_experts"] = _expert_bytes(state)
            if job["compare"] == "updates":
                ref["delta"] = {n: p - ref["p0"][n]
                                for n, p in _host_params(state.params).items()}
            del state
            torch.cuda.empty_cache()
        elif i == 0:
            out["warm_up_s"] = _warm_up()
        dist.barrier()
        state = init_distributed_state(cfg, rcfg, mesh, device="cuda")
        hook = _grad_hook(ref.pop("grads"), out) if "grads" in ref else None
        step_fn = make_shard_map_train_step(cfg, rcfg, total_steps=MESH_TOTAL, mesh=mesh,
                                            grads_hook=hook)
        state, out["mesh"] = _mesh_steps(step_fn, state, batches, mesh.comm)
        out["bytes"] = _state_bytes(state)
        out["n_params"] = sum(p.numel() for p in state.params.parameters())
        if "delta" in ref:
            dev = next(state.params.parameters()).device
            parts = _rel_by_leaf((n, p.detach().float() - ref["p0"][n].to(dev),
                                  ref["delta"][n].to(dev))
                                 for n, p in state.params.named_parameters())
            out["update_cmp"] = _rel_summary(parts)
            out["lr"] = rcfg.lr                 # the schedule's largest rate
        del state, step_fn, ref, hook
        torch.cuda.empty_cache()
        if job["ef"]:
            dist.barrier()
            ef_cfg = dataclasses.replace(rcfg, grad_compress="int8_ef")
            state = init_distributed_state(cfg, ef_cfg, mesh, device="cuda")
            step_fn = make_shard_map_train_step(cfg, ef_cfg, total_steps=MESH_TOTAL,
                                                mesh=mesh)
            grads_fn = make_shard_map_grads(cfg, ef_cfg, mesh=mesh)
            first, last = steps[0], steps[-1]
            state, rec = _mesh_steps(step_fn, state, {first: batches[first]}, mesh.comm)
            g, e_old = _ef_probe(grads_fn, state, batches[last], last)
            state, out["ef"] = _mesh_steps(step_fn, state, {last: batches[last]},
                                           mesh.comm, rec)
            out["ef_check"] = _ef_check(grads_fn, mesh, g, e_old, state.ef[EF_LEAF])
            out["ef_finite"] = all(bool(e.isfinite().all()) for e in state.ef.values())
            out["ef_norm"] = float(torch.sqrt(sum((e.double() ** 2).sum()
                                                  for e in state.ef.values())))
            out["ef_bytes"] = _state_bytes(state)["ef"]
            del state, step_fn, g, e_old
            torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:   # progress while the group runs (its report comes at the end)
            print(f"[mesh] rank 0 done with job {i} ({job['shape']}): losses "
                  f"{out['mesh']['loss']}, ms {[round(x) for x in out['mesh']['ms']]}",
                  flush=True)
        outs.append(out)
    return outs


def _gib(nbytes) -> str:
    return f"{nbytes / 2**30:.3f} GiB"


def _per_step_host(rec, steps) -> str:
    return " | ".join(f"step {s}: " + (", ".join(f"{op} {b / 2**30:.3f} GiB"
                                                  for op, b in sorted(st.items())) or "none")
                      for s, st in zip(steps, rec["host"]))


HOST_NOTE = ("card <-> host (gloo's own copies for all_reduce / all_gather, the "
             "transport's for send_recv)")


def report_mesh(label: str, job: dict, res: list, smi: str) -> None:
    """Print what each rank of one job measured, and hold the mesh to the
    single-process step and its launch counts."""
    import math

    tag = f"[{smi}]"
    data, ctx = job["shape"]
    world = data * ctx
    cfg = mesh_cfg(job["layers"])
    steps = MESH_STEPS[:job["steps"]]
    single = res[0]["single"]
    print(f"[{label}] {ARCH} {cfg.n_layers} layers, {MESH_SPEC}, remat {MESH_REMAT!r}, bf16 "
          f"compute, global batch {job['batch']} x {job['seq']}, mesh data {data} x context "
          f"{ctx} ({world} ranks on cuda:0, gloo); steps {list(steps)} {tag}")
    print(f"[{label}] single-process step (blocks={world}, rank 0 while the others wait): "
          f"losses {single['loss']} | ms {[round(x, 1) for x in single['ms']]} (the first "
          f"with rank 0's warm-up) | peak {_gib(max(single['peak']))} | moments "
          f"{_gib(res[0]['single_bytes']['moments'])} {tag}")
    want = mesh_want_launches(cfg, ctx)
    for r in res:
        rec = r["mesh"]
        warm = f" (warm-up {r['warm_up_s']:.1f} s before)" if "warm_up_s" in r else ""
        print(f"[{label}] rank {r['rank']}: losses {rec['loss']} | grad norms "
              f"{[round(g, 4) for g in rec['gnorm']]} | ms per step "
              f"{[round(x, 1) for x in rec['ms']]} ({SHARED}){warm} | peak "
              f"{[_gib(p) for p in rec['peak']]} | moments {_gib(r['bytes']['moments'])} | "
              f"{HOST_NOTE} {_per_step_host(rec, steps)} {tag}")
        for s, counts in zip(steps, rec["counts"]):
            print(f"[{label}] rank {r['rank']} step {s} launches {counts}")
            check({k: counts.get(k, 0) for k in want} == want,
                  f"{label}: rank {r['rank']} step {s} launches {counts} != {want}")
            check(not any(k.endswith(("_ref", "_f32")) for k in counts),
                  f"{label}: a plain version or an f32 route ran on rank {r['rank']}")
        check(rec["loss"] == res[0]["mesh"]["loss"],
              f"{label}: rank {r['rank']} reports other losses than rank 0")
        check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
              f"{label}: a loss or grad norm is not finite on rank {r['rank']}")
    mesh_loss = res[0]["mesh"]["loss"]
    n_cmp = len(steps) if job["compare"] == "updates" else 1
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh_loss[:n_cmp], single["loss"][:n_cmp])]
    print(f"[{label}] mesh against the single-process step: losses {mesh_loss[:n_cmp]} vs "
          f"{single['loss'][:n_cmp]}, worst rel {max(rel):.3e} (tol {TOL_MESH_LOSS}"
          + ("" if n_cmp > 1 else "; the first step: the shards draw other generator "
             "rows than the single-process blocks, so later steps part") + ")")
    check(max(rel) <= TOL_MESH_LOSS, f"{label}: the mesh's losses part from the single-"
          f"process step's")
    if job["compare"] == "grads":
        report_mesh_grads(label, steps[0], res[0]["grad_cmp"])
    print(f"[{label}] peak a step: single process {_gib(max(single['peak']))}, each rank "
          + ", ".join(_gib(max(r["mesh"]["peak"])) for r in res) + f" {tag}")


def report_mesh_grads(label: str, step: int, cmp: dict) -> None:
    """The first step's gradients, mesh (after the all-reduce) against the
    single process, at the initial parameters."""
    o, p = cmp["other"], cmp["pamm"]
    print(f"[{label}] gradients of step {step} against the single-process step: the "
          f"{o['leaves']} leaves attn.qkv does not compress, ||mesh - single|| / ||single|| "
          f"{o['rel']:.3e} (tol {TOL_MESH_GRAD}; worst leaf {o['worst']} {o['worst_rel']:.3e}) "
          f"| the {p['leaves']} compressed leaves {p['rel']:.3e} (other generator rows; "
          f"not held) | the comparison took {cmp['ms']:.1f} ms of rank 0's step")
    check(o["rel"] <= TOL_MESH_GRAD, f"{label}: the mesh's gradients part from the "
          f"single-process step's")


def report_mesh_data(res: list, smi: str) -> None:
    """The data phase's own checks: the parameters' change over the two
    steps, half the moments a rank, int8_ef."""
    tag = f"[{smi}]"
    u = res[0]["update_cmp"]
    print(f"[mesh data] parameter change over steps {list(MESH_STEPS)}: ||mesh - single|| "
          f"/ ||single|| {u['rel']:.3e} over every element (tol {TOL_MESH_UPDATE}; worst "
          f"leaf {u['worst']} {u['worst_rel']:.3e}; lr {res[0]['lr']})")
    check(u["rel"] <= TOL_MESH_UPDATE,
          "mesh data: the parameters' change parts from the single-process step's")
    single_m = res[0]["single_bytes"]["moments"]
    for r in res:
        ratio = r["bytes"]["moments"] / single_m
        print(f"[mesh data] rank {r['rank']}: moments {_gib(r['bytes']['moments'])} of the "
              f"single process's {_gib(single_m)} ({ratio:.4f}; ZeRO-1 over data 2)")
        check(ratio == 0.5, "mesh data: a rank keeps more than half the moments")
    for r in res:
        ef, un, c = r["ef"], r["mesh"], r["ef_check"]
        tol = TOL_EF_SHARE * (un["loss"][0] - un["loss"][-1])
        d = max(abs(a - b) for a, b in zip(ef["loss"], un["loss"]))
        print(f"[mesh data] int8_ef rank {r['rank']}: losses {ef['loss']} vs uncompressed "
              f"{un['loss']} (worst |diff| {d:.3e}, tol {TOL_EF_SHARE} x the uncompressed "
              f"run's decrease = {tol:.3e}) | residues {_gib(r['ef_bytes'])}, norm "
              f"{r['ef_norm']:.4e}, finite {r['ef_finite']} | ms per step "
              f"{[round(x, 1) for x in ef['ms']]} ({SHARED}) | {HOST_NOTE} "
              f"{_per_step_host(ef, MESH_STEPS)} {tag}")
        print(f"[mesh data] int8_ef rank {r['rank']} error feedback on {EF_LEAF} at step "
              f"{MESH_STEPS[-1]}: residue vs ef_quantize(g + e) {c['residue_rel']:.3e} of "
              f"||e|| = {c['residue_norm']:.4e} (tol {TOL_EF_RESIDUE}); vs the residue "
              f"without feedback {c['no_feedback_rel']:.3e} (must be >= {EF_NO_FEEDBACK}); "
              f"ranks' mean of g + e - new residue vs the compressed all-reduce "
              f"{c['mean_rel']:.3e} (tol {TOL_EF_MEAN})")
        check(d <= tol and ef["loss"][-1] < ef["loss"][0] and r["ef_finite"]
              and r["ef_norm"] > 0,
              f"mesh data: int8_ef on rank {r['rank']} parts from the uncompressed run, "
              f"does not learn, or its residues are not finite and non-zero")
        check(c["residue_rel"] <= TOL_EF_RESIDUE and c["no_feedback_rel"] >= EF_NO_FEEDBACK
              and c["mean_rel"] <= TOL_EF_MEAN,
              f"mesh data: int8_ef on rank {r['rank']}: the residue does not follow error "
              f"feedback, or the ranks' mean is not what they sent")


def phase_mesh_pair(smi, layers=None, rank_fn=None):
    """Phases 36 and 37 in one group of two ranks. 36: data 2, full width
    at ``layers`` layers (None: full depth), global 4 x 2048, two steps against the
    single-process step with blocks=2 (the same generator rows): losses,
    the parameters' change, half the moments a rank; then int8_ef with its
    residue check. 37: context 2, global 2 x 4096 (each rank a 2048 zigzag
    slice), one step: the loss and the gradients against the
    single-process step, the ring's K3 / K4 / K5 launches (5 chunk pairs a
    layer), the peaks. ``rank_fn`` replaces :func:`mesh_rank` (a planted
    fault). Returns (data, context) results."""
    from repro_torch.launch.ranks import run_ranks

    jobs = [{"shape": DATA_SHAPE, "layers": layers, "batch": DATA_BATCH, "seq": DATA_SEQ,
             "steps": 2, "compare": "updates", "ef": True},
            {"shape": CTX_SHAPE, "layers": layers, "batch": CTX_BATCH, "seq": CTX_SEQ,
             "steps": 1, "compare": "grads", "ef": False}]
    t0 = time.perf_counter()
    res = run_ranks(2, rank_fn or mesh_rank, jobs, timeout=MESH_TIMEOUT)
    print(f"[mesh] phases 36-37: two ranks, wall {time.perf_counter() - t0:.1f} s "
          f"(spawn, warm-up and both phases)")
    data, ctx = ([r[i] for r in res] for i in range(2))
    report_mesh("mesh data", jobs[0], data, smi)
    report_mesh_data(data, smi)
    report_mesh("mesh context", jobs[1], ctx, smi)
    return data, ctx


def phase_mesh_data_context(smi):
    """Phase 38: four ranks, data 2 x context 2, full width cut to 4
    layers (the state bytes reckoned and printed first), global 4 x 4096,
    one step: the loss and the gradients against the single-process step,
    the launches."""
    from repro_torch.launch.ranks import run_ranks

    cfg = mesh_cfg(DC_LAYERS)
    d, H, KV, dh, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                           cfg.vocab_size)
    per_layer = 2 * d + d * (H + 2 * KV) * dh + H * dh * d + 3 * d * ff
    n = 2 * V * d + d + DC_LAYERS * per_layer
    data, ctx = DC_SHAPE
    per_rank = {"params": 4 * n, "grads": 4 * n, "moments": 2 * 4 * n // data}
    print(f"[mesh data x context] reckoned before the run: {n / 1e9:.3f} B params; per rank "
          + ", ".join(f"{k} {_gib(v)}" for k, v in per_rank.items())
          + f" = {_gib(sum(per_rank.values()))}, x {data * ctx} ranks = "
          f"{_gib(data * ctx * sum(per_rank.values()))} of state on one 80 GB card, beside "
          f"each rank's activations (2 x 2048 tokens under remat 'pamm')")
    job = {"shape": DC_SHAPE, "layers": DC_LAYERS, "batch": DC_BATCH, "seq": DC_SEQ,
           "steps": 1, "compare": "grads", "ef": False}
    t0 = time.perf_counter()
    res = [r[0] for r in run_ranks(data * ctx, mesh_rank, [job], timeout=MESH_TIMEOUT)]
    print(f"[mesh] phase 38: four ranks, wall {time.perf_counter() - t0:.1f} s")
    report_mesh("mesh data x context", job, res, smi)
    check(res[0]["n_params"] == n, f"the reckoned {n} params != the model's "
          f"{res[0]['n_params']}")
    return res


def ring_pair_rows(gen, ctx_res, errs, smi):
    """Kernel rows of K3, K4 and K5 at the ring's chunk shape (2, 1024, 16
    / 8, 128) bf16, on the fully visible pair (q_off 3C, k_off C): SDPA
    without a mask computes the same function, so it is the library; the
    launches are rank 0's in the context phase's two steps."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (_delta, _launch_dkv, _launch_dq,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_fwd_cuda,
                                                     flash_attention_fwd_ref)

    tag = f"[{smi}]"
    B, C, H, KV, dh = RING_B, RING_C, 16, 8, 128
    offs = (3 * C, C)
    q = _randn((B, C, H, dh), gen)
    kk, v = _randn((B, C, KV, dh), gen), _randn((B, C, KV, dh), gen)
    do = _randn((B, C, H, dh), gen)
    qt = q.transpose(1, 2).detach().requires_grad_()
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).detach().requires_grad_()
              for t in (kk, v))
    o, lse = flash_attention_fwd_cuda(q, kk, v, causal=True, offs=offs)
    delta = _delta(o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(kk), torch.empty_like(v)
    out = F.scaled_dot_product_attention(qt, kx, vx)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kx, vx), do.transpose(1, 2),
                                           retain_graph=True)
    plain_bwd = lambda: flash_attention_bwd_ref(q, kk, v, o, lse, do, causal=True, offs=offs)
    pairs = C * C
    io = B * C * (2 * H + 2 * KV) * dh * 2
    launches = ctx_res[0]["mesh"]["counts"][0]
    at = f"ring chunk pair ({B}, {C}, {H}/{KV}, {dh}) offs {offs}"
    rows = [
        _kernel_row(f"flash_attention_fwd (K3, {at})", K3_SOURCE, K3_OFFS_REPLACES,
                    launches.get("flash_attention_fwd", 0), errs["K3"],
                    lambda: flash_attention_fwd_cuda(q, kk, v, causal=True, offs=offs),
                    lambda: flash_attention_fwd_ref(q, kk, v, causal=True, offs=offs),
                    lambda: F.scaled_dot_product_attention(qt, kx, vx),
                    (4.0 * dh * pairs * H * B, io + B * H * C * 4)),
        _kernel_row(f"flash_attention_dq (K4, {at})", K45_SOURCE, K4_OFFS_REPLACES,
                    launches.get("flash_attention_dq", 0), errs["K4"],
                    lambda: _launch_dq(q, kk, v, lse, delta, do, dq, True, 0, offs),
                    plain_bwd, sdpa_bwd,
                    (6.0 * dh * pairs * H * B, io + 2 * B * H * C * 4 + B * C * H * dh * 2)),
        _kernel_row(f"flash_attention_dkv (K5, {at})", K45_SOURCE, K5_OFFS_REPLACES,
                    launches.get("flash_attention_dkv", 0), errs["K5"],
                    lambda: _launch_dkv(q, kk, v, lse, delta, do, dk, dv, True, 0, offs),
                    plain_bwd, sdpa_bwd,
                    (8.0 * dh * pairs * H * B,
                     io + 2 * B * H * C * 4 + 2 * B * C * KV * dh * 2))]
    note = "launches on rank 0 in the context phase's step"
    print_rows(rows, [(note, "")] * 3, tag)
    torch.cuda.empty_cache()
    return rows


def run_mesh_phases(gen, smi, layers=MESH_LAYERS):
    """Phases 35-39: the ring's kernels at its chunk shape, the mesh
    executor on data 2 and context 2 ranks (one group) and on data 2 x
    context 2 ranks sharing the card, the ring's kernel rows. ``layers``
    sets the data and context phases' depth (None: full depth)."""
    errs = phase_ring_kernels(gen)
    _, ctx = phase_mesh_pair(smi, layers)
    phase_mesh_data_context(smi)
    return ring_pair_rows(gen, ctx, errs, smi)


# ---------------------------------------------------------------------------
# the data axis in one process: sharded page pools, MoE's blocked dispatch
# ---------------------------------------------------------------------------
# sharded serving: 8 requests of 256 - 3 (i % 4) prompt tokens and 32 new,
# greedy, at max_len 289 (5 blocks of 64 a slot, 5 pages a request); the
# pool of every run is 28 pages of 64 in bf16 (five requests' reservations,
# divisible by 4), so one engine holds 5 requests, a shard of 14 or 7 pages
# 2 or 1 (int8 pools get the byte budget's 1.94x pages, capped at the 40 of
# the dense worst case)
SHARD_PROMPT, SHARD_GEN, SHARD_REQUESTS = 256, 32, 8
SHARD_POOL = 28 * PAGE
SHARD_RUNS = ((2, ""), (2, "int8"), (4, ""))
SHARD_SOURCE = K78_SOURCE
SHARD_REPLACES = {"": "src/repro/kernels/flash_decode.py:621",
                  "int8": "src/repro/kernels/flash_decode.py:666"}
MOE_BLOCKS = 2
TOL_MOE_CPU = 1e-5   # moe_ffn blocked, card vs CPU in f32: relative norm


def sharded_inputs(gen, dp, Lq=1, quant=None):
    """The sharded wrappers' inputs at the sharded serving shape: SLOTS
    slots over ``dp`` shards, each slot 5 mapped blocks of PAGE at shuffled
    shard-local pages (``paged_inputs`` per shard), SHARD_PROMPT + 17
    tokens written, row 3 parked; internlm2's heads. Returns (q, q_pos,
    pools, block_table, page_pos, folded) with ``pools`` (k, v) or (k, v,
    k_scale, v_scale) and ``folded`` the same pools as one unsharded pool
    (views) and the offset table."""
    import torch

    from repro_torch.kernels.flash_decode import quantize_kv, shard_offset_table

    H, KV, dh, nb = 16, 8, 128, 5
    bs = SLOTS // dp
    fill = [SHARD_PROMPT + 17] * bs
    parts = [paged_inputs(gen, bs, nb, PAGE, KV, dh, fill) for _ in range(dp)]
    k, v, bt, ppos = (torch.stack(t) for t in zip(*parts))
    pools = (k, v)
    if quant is not None:
        (kq, ks), (vq, vs) = (quantize_kv(t, quant, 1) for t in (k, v))
        pools = (kq, vq, ks, vs)
    q = _randn((SLOTS, Lq, H, dh), gen)
    qpos = (torch.full((SLOTS, 1), fill[0] - Lq, device="cuda")
            + torch.arange(Lq, device="cuda")).to(torch.int32)
    qpos = qpos[:, 0].contiguous() if Lq == 1 else qpos
    qpos[3] = -1
    folded = ([t.view(-1, *t.shape[2:]) for t in pools + (ppos,)],
              shard_offset_table(bt, k.shape[1]))
    return q, qpos, pools, bt, ppos, folded


def check_sharded(gen, dp, Lq=1, quant=None):
    """A sharded wrapper against its plain version (the per-shard plain
    K7 / K8), two launches bitwise equal, and equal bitwise to K7 / K8 on
    the folded pool through the offset table (the same launch). Returns
    (name, max |o - o_ref| over the rows that see a key)."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    q, qpos, pools, bt, ppos, (flat, table) = sharded_inputs(gen, dp, Lq, quant)
    if quant is None:
        name = "flash_sharded_paged_decode"
        run = lambda: fd.flash_sharded_paged_decode_cuda(q, *pools, qpos, bt, ppos)
        ref = fd.flash_sharded_paged_decode_ref(q, *pools, qpos, bt, ppos)
        one = fd.flash_paged_decode_cuda(q, flat[0], flat[1], qpos, table, flat[2])
    else:
        name = "flash_sharded_paged_decode_quant"
        run = lambda: fd.flash_sharded_paged_decode_quant_cuda(q, *pools, qpos, bt, ppos)
        ref = fd.flash_sharded_paged_decode_quant_ref(q, *pools, qpos, bt, ppos)
        one = fd.flash_paged_decode_quant_cuda(q, *flat[:4], qpos, table, flat[4])
    o, again = run(), run()
    label = f"dp {dp}, Lq {Lq}, {'bf16' if quant is None else f'int{quant}'} pages"
    check(torch.equal(o, again) and torch.equal(o, one),
          f"{name} ({label}): two launches, or the launch on the folded pool, differ")
    seen = paged_visible(table, flat[-1], qpos, 0).any(-1)
    err = (o[seen].float() - ref[seen].float()).abs().max().item()
    e_row = row_err(o[seen], ref[seen])
    print(f"[sharded] {name} {SLOTS} slots over {label}, 5 pages of {PAGE} a slot, 16/8, "
          f"128: max|o-o_ref|={err:.3e} (tol {TOL_O}) worst row rel {e_row:.3e} (tol "
          f"{TOL_ROW}); two launches bitwise equal and equal to one launch on the folded "
          f"pool")
    check(bool(o.isfinite().all()) and err <= TOL_O and e_row <= TOL_ROW,
          f"{name} disagrees with its plain version ({label})")
    return name, err


def phase_sharded_kernels(gen):
    """Phase 40: the sharded wrappers against their plain versions."""
    errs = {"flash_sharded_paged_decode": 0.0, "flash_sharded_paged_decode_quant": 0.0}
    for dp, Lq, quant in ((2, 1, None), (4, 1, None), (2, 5, None), (2, 1, 8), (4, 1, 4)):
        name, e = check_sharded(gen, dp, Lq, quant)
        errs[name] = max(errs[name], e)
    return errs


def _sharded_requests(cfg):
    from repro_torch.launch.serve import _build_requests

    args = argparse.Namespace(prompt_len=SHARD_PROMPT, requests=SHARD_REQUESTS,
                              gen=SHARD_GEN, temperature=0.0, top_k=0, seed=0)
    return _build_requests(cfg, args)


def _sharded_run(eng, cfg):
    """Serve the sharded phase's requests step by step with the launch
    counts set to 0 just before and read just after; the fewest free pages
    each replica had after a step."""
    import torch

    from repro_torch.kernels import launches

    low = [min(a.spec.n_pages for a in pools) for pools in eng.replica_allocators]
    torch.cuda.synchronize()
    launches.reset()
    for r in _sharded_requests(cfg):
        eng.submit(r)
    out = {}
    while eng.has_work:
        for o in eng.step():
            out[o.uid] = o
        low = [min(lo, *(a.free_pages for a in pools))
               for lo, pools in zip(low, eng.replica_allocators)]
    torch.cuda.synchronize()
    return out, launches.counts(), low


def phase_sharded_serving(dense, smi):
    """Phase 41: one engine's page pools split into per-replica shards of
    an in-process data mesh (dp 2 over fp and int8 pools, dp 4 over fp),
    internlm2-1.8b at full width cut to SERVE_REPS, against one engine over the
    same pool: tokens, launches, throughput, concurrency, the offset's
    host time. Two rounds, the second in the reverse order (walls move
    between runs of one call). Returns the first round's launch counts of
    each sharded run."""
    import torch

    from repro_torch.kernels.flash_decode import shard_offset_table
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.attention import paged_write
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.cache import kv_cache_nodes

    cfg, rcfg, model = dense["cfg"], dense["rcfg"], dense["model"]
    t0 = time.perf_counter()
    engine = lambda dp, fmt: ServeEngine(
        cfg, rcfg, model, max_slots=SLOTS, max_len=SHARD_PROMPT + SHARD_GEN + 1,
        decode_block=DECODE_BLOCK, cache_layout="paged", page_size=PAGE,
        pool_tokens=SHARD_POOL, cache_compress=fmt or None,
        mesh=make_local_mesh(dp) if dp > 1 else None)
    reqs = {r.uid: r for r in _sharded_requests(cfg)}
    engine(2, "").run(list(reqs.values()))                 # warm-up
    n = cfg.n_layers
    pos = torch.full((SLOTS, 1), SHARD_PROMPT, dtype=torch.int32, device="cuda")
    configs = [(1, ""), (2, ""), (4, ""), (1, "int8"), (2, "int8")]
    runs = {c: [] for c in configs}
    for dp, fmt in configs + configs[::-1]:
        label = f"dp {dp} {fmt or 'bf16'}" if dp > 1 else f"one engine {fmt or 'bf16'}"
        eng = engine(dp, fmt)
        out, counts, low = _sharded_run(eng, cfg)
        st = eng.stats()
        check(sorted(out) == sorted(reqs) and all(len(o.tokens) == SHARD_GEN
                                                   for o in out.values())
              and st["nonfinite_logits"] == 0,
              f"sharded {label}: a request did not finish, or logits were not finite")
        check(eng.n_replicas == dp and st["replica_shards"] == dp
              and len(eng.allocators) == dp, f"sharded {label}: not {dp} replicas")
        for a in eng.allocators:
            a.check_invariant()
            check(a.free_pages == a.spec.n_pages, f"sharded {label}: pages stayed reserved")
        served = [sum(a.total_page_allocations for a in pools) > 0
                  for pools in eng.replica_allocators]
        check(dp != 4 or all(served), f"sharded {label}: a replica served no request")
        kname = "flash_paged_decode" + ("_quant" if fmt else "")
        wname = "flash_sharded_paged_decode" + ("_quant" if fmt else "")
        want = {kname: n * st["decode_steps"], wname: n * st["decode_steps"] if dp > 1 else 0,
                "flash_attention_fwd": n * SHARD_REQUESTS, "flash_decode": 0,
                "flash_attention_fwd_f32": 0}
        check({k: counts.get(k, 0) for k in want} == want
              and not any(k.endswith("_ref") for k in counts),
              f"sharded {label}: launches {counts}, want {want} (K7 / K8 = {n} x decode "
              f"steps, one launch a layer whatever dp) and no plain version")
        node = next(kv_cache_nodes(eng.caches))
        off_ms = (host_ms(lambda: shard_offset_table(node.block_table, node.k_pages.shape[2]))
                  if dp > 1 else 0.0)
        runs[(dp, fmt)].append({"out": out, "counts": counts, "low": low, "stats": st,
                                "served": served, "off_ms": off_ms,
                                "plan_ms": host_ms(lambda: paged_write(node, pos)),
                                "pages": eng.allocators[0].spec.n_pages})
    res = {}
    for dp, fmt in SHARD_RUNS:
        label = f"dp {dp} {fmt or 'bf16'}"
        got, base = runs[(dp, fmt)], runs[(1, fmt)]
        r = got[0]
        print(f"[sharded] {label} launches {r['counts']} | prefills 8 | decode steps "
              f"{r['stats']['decode_steps']} (one engine: {base[0]['stats']['decode_steps']})")
        one = {u: o.tokens for u, o in base[0]["out"].items()}
        for g in got:
            for u in sorted(u for u in g["out"] if g["out"][u].tokens != one[u]):
                first_divergence_near_tie(cfg, rcfg, model, reqs[u], one[u],
                                          g["out"][u].tokens, f"{label} vs one engine",
                                          tag="sharded")
        same = sum(r["out"][u].tokens == one[u] for u in one)
        stat = lambda runs_, k, f=".1f": " / ".join(f"{x['stats'][k]:{f}}" for x in runs_)
        print(f"[sharded] {label}: tokens equal to one engine's for {same}/{SHARD_REQUESTS} "
              f"requests | decode tok/s rounds 1 / 2: {stat(got, 'decode_tok_s')} (one engine "
              f"{stat(base, 'decode_tok_s')}) | p50 ms a step {stat(got, 'p50_token_latency_ms', '.3f')} "
              f"(one engine {stat(base, 'p50_token_latency_ms', '.3f')}), p95 "
              f"{stat(got, 'p95_token_latency_ms', '.3f')} (one engine "
              f"{stat(base, 'p95_token_latency_ms', '.3f')}) | peak concurrency "
              f"{r['stats']['peak_active']} (one engine {base[0]['stats']['peak_active']}) | "
              f"pages a replica {r['pages']} (one engine {base[0]['pages']}), fewest free "
              f"after a step {r['low']}, free at the end {r['pages']} each | replicas that "
              f"served {sum(r['served'])}/{dp} | host us a step: the id offset "
              f"{1e3 * r['off_ms']:.1f}, the write plan with it {1e3 * r['plan_ms']:.1f} "
              f"(one engine's plan {1e3 * base[0]['plan_ms']:.1f}) [{smi}]")
        res[(dp, fmt)] = r["counts"]
    print(f"[sharded] phase 41 wall {time.perf_counter() - t0:.1f} s")
    return res


def sharded_rows(gen, counts, errs, smi):
    """Kernel rows of the two sharded wrappers at dp 2 (the fp and int8
    serving shapes), timed as every row, beside K7 / K8 on the folded
    pool (the unsharded pool at the same live pages); the fp wrapper at
    dp 4 printed the same way."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd

    H, KV, dh = 16, 8, 128
    rows = []
    for dp, quant, fmt in ((2, None, ""), (2, 8, "int8"), (4, None, "")):
        q, qpos, pools, bt, ppos, (flat, table) = sharded_inputs(gen, dp, 1, quant)
        work = paged_work(table, flat[-1], qpos, H, KV, dh,
                          2 * dh if quant is None else dh + 4, dh)
        if quant is None:
            name, fn = "flash_sharded_paged_decode", fd.flash_sharded_paged_decode_cuda
            plain, kernel = fd.flash_sharded_paged_decode_ref, fd.flash_paged_decode_cuda
            b = table.clamp_min(0).long()
            kx, vx = (t[b].reshape(SLOTS, -1, KV, dh).repeat_interleave(H // KV, dim=2)
                      .transpose(1, 2) for t in flat[:2])
            mask = paged_visible(table, flat[-1], qpos, 0)[:, None]
            qt = q.transpose(1, 2)
            lib = lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask)
        else:
            name = "flash_sharded_paged_decode_quant"
            fn, plain = fd.flash_sharded_paged_decode_quant_cuda, \
                fd.flash_sharded_paged_decode_quant_ref
            kernel, lib = fd.flash_paged_decode_quant_cuda, None
        row = _kernel_row(
            f"{name} (K7 / K8 over dp {dp} shards, folded and offset)", SHARD_SOURCE,
            SHARD_REPLACES[fmt], counts[(dp, fmt)].get(name, 0), errs[name],
            lambda: fn(q, *pools, qpos, bt, ppos),
            lambda: plain(q, *pools, qpos, bt, ppos), lib, work)
        flush = _flush_buffer()
        with_table = time_ms(lambda: fn(q, *pools, qpos, bt, ppos, table=table), flush=flush)
        folded = time_ms(lambda: kernel(q, *flat[:-1], qpos, table, flat[-1]), flush=flush)
        folded_dev = time_ms(lambda: kernel(q, *flat[:-1], qpos, table, flat[-1]),
                             flush=flush, pad=True)
        lib_s = ("none" if row["library_ms"] is None
                 else f"{row['library_ms']:.4f} ms (SDPA over the keys laid out densely)")
        print(f"[numbers] {row['name']}: {row['ms']:.4f} ms/call | device only "
              f"{row['device_ms']:.4f} ms | wrapper host {1e3 * row['host_ms']:.1f} us/call | "
              f"with the step's offset table {with_table:.4f} ms | K7 / K8 on the unsharded "
              f"pool at the same live pages {folded:.4f} ms (device only {folded_dev:.4f}) | "
              f"plain {row['plain_ms']:.4f} ms | library {lib_s} | bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | {row['launches']} launches on "
              f"its dp-{dp} serving run [{smi}]")
        if dp == 2:
            rows.append(row)
    return rows


def phase_moe_blocked(smi):
    """Phase 42: granite-moe-3b-a800m's blocked MoE dispatch
    (moe_token_blocks = 2) at the serving cut (8 layers, full width): one
    training step under remat='pamm' and the MoE rules, twice from the
    seed; a paged engine decoding with blocks 2 held to a teacher-forced
    blocked forward; moe_ffn blocked, card against the CPU in f32."""
    import dataclasses
    import math
    import warnings

    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import init_model, moe
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    cfg = serve_cfg(MOE_ARCH)
    L = cfg.n_layers
    rcfg = RunConfig(compression=MOE_SPEC, policy_name="none", remat="pamm",
                     moe_token_blocks=MOE_BLOCKS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _, rec = _train_run(cfg, rcfg, 1, measure=True)
        del state
        torch.cuda.empty_cache()
        _, _, rec2 = _train_run(cfg, rcfg, 0, measure=False)
    torch.cuda.empty_cache()
    notes = sorted({str(w.message) for w in caught if "blocked" in str(w.message)})
    for msg in notes:
        print(f"[moe blocked] warning: {msg}")
    check(any("will train exact" in m for m in notes)
          and any("not applied on the blocked" in m for m in notes),
          "moe blocked: the downgrade warnings were not given")
    counts = rec["counts"]
    print(f"[moe blocked] {MOE_ARCH} cut to {L} layers, {MOE_SPEC}, remat='pamm', "
          f"moe_token_blocks {MOE_BLOCKS}, batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          f"{rec['loss']} (a second run from the seed: {rec2['loss']}) | step "
          f"{rec['ms'][1]:.1f} ms | peak {rec['peak'] / 2**30:.3f} GiB | launches {counts} "
          f"[{smi}]")
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"])
          and rec2["loss"][0] == rec["loss"][0],
          "moe blocked: a loss is not finite, or a second run gives another")
    want = {"csim_argmax": L, "segment_matmul": 3 * L, "csim_argmax_batched": 0,
            "segment_matmul_batched": 0, "flash_attention_fwd": 2 * L,
            "flash_attention_dq": L, "flash_attention_dkv": L}
    check({k: counts.get(k, 0) for k in want} == want
          and not any(k.endswith("_ref") for k in counts),
          f"moe blocked: launches {counts}, want {want} (attn.qkv's K1 / K2 as unblocked, "
          f"no batched K1 / K2) and no plain version")

    # decode with blocks 2 at capacity factor 16 (nothing dropped, so a
    # teacher-forced blocked forward is the reference)
    cfg16 = dataclasses.replace(cfg, capacity_factor=16.0)
    srcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none",
                      moe_token_blocks=MOE_BLOCKS)
    model = init_model(cfg16, srcfg, seed=0, device="cuda")
    eng = ServeEngine(cfg16, srcfg, model, max_slots=SLOTS,
                      max_len=SHARD_PROMPT + SHARD_GEN + 1, decode_block=DECODE_BLOCK,
                      cache_layout="paged", page_size=PAGE)
    out, counts = _counted(lambda: eng.run(_sharded_requests(cfg16)))
    st = eng.stats()
    check(sorted(out) == list(range(SHARD_REQUESTS)) and st["nonfinite_logits"] == 0,
          "moe blocked decode: a request did not finish or logits were not finite")
    want = {"flash_attention_fwd": L * SHARD_REQUESTS,
            "flash_paged_decode": L * st["decode_steps"]}
    check({k: counts.get(k, 0) for k in want} == want
          and not any(k.endswith("_ref") for k in counts),
          f"moe blocked decode: launches {counts}, want {want} and no plain version")
    tf = [teacher_forced(cfg16, srcfg, model, r, out[r.uid].tokens, "moe blocked")
          for r in _sharded_requests(cfg16)]
    print(f"[moe blocked] paged decode with blocks {MOE_BLOCKS}, capacity factor 16: "
          f"launches {counts}; every token of the {SHARD_REQUESTS} greedy streams vs a "
          f"teacher-forced blocked forward: {sum(d for d, _ in tf)} of "
          f"{SHARD_REQUESTS * SHARD_GEN} differ, their largest gap to the top logit "
          f"{max(w for _, w in tf):.4f} (near tie < {TOL_NEAR}) | decode "
          f"{st['decode_tok_s']:.1f} tok/s [{smi}]")
    del model, eng
    torch.cuda.empty_cache()

    # moe_ffn blocked, card against CPU in f32 at smoke size
    scfg = get_config(MOE_SMOKE)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, scfg, torch.float32)
    x = torch.randn((2, 16, scfg.d_model), generator=gen)
    w = torch.randn(x.shape, generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().to(dev).requires_grad_() for k, v in params.items()}
        xd = x.detach().to(dev).requires_grad_()
        out_b, aux = moe.moe_ffn(p, xd, scfg, token_blocks=MOE_BLOCKS)
        (out_b * w.to(dev)).sum().add(aux).backward()
        res[dev] = {"out": out_b.detach().cpu(), "x": xd.grad.cpu(),
                    **{k: v.grad.cpu() for k, v in p.items()}}
    worst = max(float((res["cuda"][k] - v).norm() / v.norm().clamp_min(1e-30))
                for k, v in res["cpu"].items())
    print(f"[moe blocked] moe_ffn {MOE_SMOKE} blocks {MOE_BLOCKS}, f32: card vs CPU, output "
          f"and every gradient, worst relative norm {worst:.2e} (tol {TOL_MOE_CPU})")
    check(worst <= TOL_MOE_CPU, "moe blocked: moe_ffn on the card disagrees with the CPU")
    print(f"[moe blocked] phase 42 wall {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# tensor parallelism: the model axis over gloo ranks on one card
# ---------------------------------------------------------------------------
TP_SHAPE, TP_LAYERS = (1, 2), None               # phase 43: model 2, full depth
DTP_SHAPE, DTP_LAYERS = (2, 2), 4                # phase 44: data 2 x model 2, 4 layers
TP_BATCH, TP_SEQ = DATA_BATCH, DATA_SEQ          # the data phase's batch: 4 x 2048
# a warm-up step (the warmup-cosine rate is 0 at index 0: the parameters
# stay, the moments move) and two measured steps
TP_STEPS = (0, 1, 2)
TP_GRAD_STEP = 1          # the step whose gradients are held, at the initial parameters
TP_HEADS = (8, 4, 128)    # internlm2's 16 / 8 heads of 128 on each of 2 model ranks
TP_SITE = (TRAIN_BATCH * TRAIN_SEQ, 2048, 16)   # attn.qkv's (b, n, k) at r=1/512
TP_K2_M = ((1024, "wq"), (512, "wk / wv"))      # K2's dZ columns a rank at tp 2


def tp_job_cfg(job: dict):
    """(cfg, rcfg) of a tensor-parallel job: ``arch`` (default ARCH) cut to
    ``layers`` (None: full depth) of its one stage's unit, or to the
    ``stages`` given, ``spec`` (default MESH_SPEC) under remat MESH_REMAT,
    ``run``: other RunConfig fields (a ``remat`` among them replaces
    MESH_REMAT)."""
    import dataclasses

    from repro_torch.configs import RunConfig, get_config

    cfg = get_config(job.get("arch", ARCH))
    if job.get("stages"):
        cfg = dataclasses.replace(cfg, stages=job["stages"], n_layers=sum(
            len(unit) * rep for unit, rep in job["stages"]))
    elif job.get("layers"):
        (unit, _), = cfg.stages
        cfg = dataclasses.replace(cfg, stages=((unit, job["layers"]),), n_layers=job["layers"])
    rcfg = RunConfig(compression=job.get("spec", MESH_SPEC), policy_name="none",
                     **{"remat": MESH_REMAT, **job.get("run", {})})
    return cfg, rcfg


def tp_want_launches(job: dict, cfg) -> dict:
    """Launches a tensor-parallel step makes on each rank: the attention
    layers' (:func:`tp_attn_launches`), plus under an ``ffn.*`` rule K1
    once (gate / up share a state) and K2 three times a layer and
    ffn.down's split route (pass A and pass B once a layer), plus under
    ``moe.expert`` the batched K1 once and the batched K2 twice (gate, up)
    a layer, over the rank's experts."""
    if job.get("arch") in (SSM_ARCH, REC_ARCH):
        return tp_kind_launches(job, cfg)
    want = tp_attn_launches(job, cfg)
    n, spec = cfg.n_layers, job.get("spec", MESH_SPEC)
    if "ffn.*" in spec:
        want["csim_argmax"] += n
        want["segment_matmul"] += 3 * n
        want.update(csim_partial=n, csim_finish=n)
    if "moe.expert" in spec:
        want.update(csim_argmax_batched=n, segment_matmul_batched=2 * n)
    return want


# the leaves whose gradient each compression rule's site estimates (a moe
# block's experts sit under its "ffn" node)
SITE_LEAVES = {"attn.qkv": ("attn.wq", "attn.wk", "attn.wv"),
               "ffn.*": ("ffn.w_gate", "ffn.w_up", "ffn.w_down"),
               "moe.expert": ("ffn.w_gate", "ffn.w_up"),
               "ssm.in": ("ssm.in_proj",), "rglru.in": ("rec.w_x",)}


def _site_leaves(spec: str) -> tuple:
    """Suffixes of the leaves the compressed sites of ``spec`` estimate."""
    rules = [r.split("=")[0] for r in spec.split(";") if r and not r.endswith("=none")]
    return tuple(x for r in rules for x in SITE_LEAVES.get(r, ()))


def _with_blocks(spec: str, n: int) -> str:
    """Every rule of ``spec`` with ``blocks=n``."""
    return ";".join(r[:-1] + f",blocks={n})" for r in spec.split(";"))


def _expert_bytes(state) -> dict:
    """Bytes of the MoE expert leaves ((layers, E, ., .)) and their moments."""
    names = {n for n, p in state.params.named_parameters() if p.dim() == 4}
    size = lambda t: t.numel() * t.element_size()
    return {"params": sum(size(p) for n, p in state.params.named_parameters() if n in names),
            "moments": sum(size(t) for tree in (state.opt.m, state.opt.v)
                           for n, t in tree.items() if n in names)}


def _ref_slices(full: dict | None, local: dict, mesh, cfg, rcfg,
                on_host: bool = False) -> dict | None:
    """This rank's model-axis slice of each of rank 0's leaves ``full``
    (the single process's, f32 on the card), on the model ranks of data
    coordinate 0: rank 0 sends the others theirs over gloo through host
    memory, leaf by leaf (gloo takes no CUDA tensor in send / recv; its own
    slices are views); None on the other ranks. ``local``: this rank's
    tensors, for the names, shapes and layout. ``on_host``: the slices stay
    in host memory (``full`` is there too)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.model import _padded_vocab
    from repro_torch.runtime import sharding as sh

    if mesh.coord("data") != 0:
        return None
    v_pad, e_pad = _padded_vocab(cfg, rcfg), sh.padded_experts(cfg, rcfg)
    tp, me = sh.tp_degree(mesh), mesh.coord("model")
    out = {}
    for n, t in local.items():
        cut = sh.local_model_cut(n, tuple(t.shape), cfg, v_pad, e_pad)
        take = (lambda r: full[n]) if cut is None else (lambda r: cut.take(full[n], r, tp))
        if me == 0:
            for m in range(1, tp):      # data 0's model ranks are global ranks 0..tp-1
                dist.send(take(m).contiguous().cpu(), dst=m)
            out[n] = take(0)
        else:
            host = torch.empty(t.shape, dtype=torch.float32)
            dist.recv(host, src=0)
            out[n] = host if on_host else host.to(t.device)
    return out


def _held_bytes(*trees) -> int:
    """Bytes of the card storage behind the tensors of ``trees`` (dicts;
    None skipped), each storage once: what a rank holds for the comparison
    and takes out of its measured peak."""
    seen = {}
    for tree in trees:
        for t in (tree or {}).values():
            if t.device.type == "cuda":
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _tp_parts(tensors: dict, ref: dict | None, layout=None, tp: int = 1) -> dict:
    """(||a - ref||^2, ||ref||^2) of each leaf ``a`` of ``tensors`` (this
    rank's slices) against ``ref`` (this rank's slices of the single
    process's); {} without ``ref``. A leaf whose ``layout`` cut has whole
    parts (every rank holds them) counts them 1/tp on each rank, so that
    the ranks' sums are the whole leaf's."""
    if ref is None:
        return {}
    out = _rel_by_leaf((n, t.detach().float(), ref[n].to(t.device))
                       for n, t in tensors.items())
    for n, cut in (layout or {}).items():
        idx = [] if cut is None else cut.whole_index(tp)
        if idx:
            a = tensors[n].detach().float()
            whole = _rel_by_leaf((i, a[ix], ref[n][ix].to(a.device))
                                 for i, ix in enumerate(idx)).values()
            out[n] = tuple(out[n][j] - (1 - 1 / tp) * sum(w[j] for w in whole) for j in (0, 1))
    return out


def _tp_whole_parts(res: list, key: str, label: str) -> dict:
    """The whole leaves' parts from the model ranks' slices (data
    coordinate 0): a split leaf's summed over the ranks; a whole leaf's
    rank 0's, which every rank's copy must equal."""
    ranks = [r for r in res if r["coord"][0] == 0]
    out = {}
    for n, whole in ranks[0][key].items():
        if n in ranks[0]["split"]:
            out[n] = tuple(sum(r[key][n][i] for r in ranks) for i in (0, 1))
        else:
            check(all(r[key][n] == whole for r in ranks),
                  f"{label}: the model ranks' copies of the whole leaf {n} differ")
            out[n] = whole
    return out


def _free_pinned() -> None:
    """Release the pinned host blocks that gloo's copies of large CUDA
    tensors left in the caching host allocator, so later collectives do
    not run beside them."""
    import torch

    getattr(torch._C, "_host_emptyCache", lambda: None)()


def _tp_grad_hook(ref, out: dict, layout=None, tp: int = 1):
    """A ``grads_hook`` for every rank: at step TP_GRAD_STEP the parts of
    the gradients after the data all-reduce (this rank's slices) against
    the single process's (``ref``: this rank's slices of them, None on
    the ranks that do not compare) into ``out["grad_parts"]``, with the
    comparison's own ms (inside the step's)."""
    import torch

    calls = [0]

    def hook(grads):
        at = TP_STEPS[calls[0]]
        calls[0] += 1
        if at != TP_GRAD_STEP:
            return
        t0 = time.perf_counter()
        out["grad_parts"] = _tp_parts(grads, ref, layout, tp)
        torch.cuda.synchronize()
        out["grad_cmp_ms"] = 1e3 * (time.perf_counter() - t0)

    return hook


def _fill_gates(model, job: dict) -> None:
    """A job's xattn gates (``gates``: their value) filled in place."""
    if job.get("gates") is not None:
        set_gates(model, job["gates"])


def _recording_cross_states(out: list, job: dict):
    """For a job with ``cross_rows`` (the attn.cross_kv site's rows: B x
    image tokens), record a digest of every compressed state of that many
    rows (the attn.qkv sites compress B x L rows) into ``out``; returns
    what undoes it."""
    import torch

    from repro_torch.core import linear

    rows = job.get("cross_rows")
    if not rows:
        return lambda: None
    real = linear._compress

    def compress(policy, x2d, key, split):
        state = real(policy, x2d, key, split)
        if x2d.shape[0] == rows:
            h = hashlib.sha1()
            for t in linear._leaves(state):
                if isinstance(t, torch.Tensor):
                    h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                             .numpy().tobytes())
            out.append(h.hexdigest())
        return state

    linear._compress = compress

    def undo():
        linear._compress = real
    return undo


def tp_rank(rank: int, world: int, jobs: list) -> list:
    """One gloo rank of phases 43-44 (``launch.ranks`` starts it), every
    rank on cuda:0, running ``jobs`` in turn, each on its own (data, model)
    mesh. Rank 0 first runs the single-process step on the whole global
    batch with blocks = the data degree (the others wait at a barrier,
    warming up before the first job) and keeps on the card the gradients
    of step TP_GRAD_STEP at the initial parameters (the rate is 0 at index
    0, so step 0 leaves them) and the parameters after the steps, and
    hands each model rank of data coordinate 0 its model-axis slices of
    them; then every rank runs the mesh executor from the same seed (its
    slices of the same draws), and those ranks hold their gradients at
    step TP_GRAD_STEP and their parameters after the steps to their
    slices; with ``moments``, the moments gathered whole and each rank's
    held to its slices of them. ``gates`` fills the xattn gates of both
    runs' parameters; ``cross_rows`` records a digest of each attn.cross_kv
    state of both runs' steps; ``residual_peak`` runs the mesh steps again
    on the residual structure, for their peaks."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core.keys import Key
    from repro_torch.core.plan import resolve_for_run
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.models.model import _padded_vocab
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.collectives import gather_model_
    from repro_torch.train import (init_distributed_state, init_train_state, loss_and_grad,
                                   make_shard_map_train_step, make_train_step)
    from repro_torch.train.distributed import gathered_moments, zero1_of
    from repro_torch.train.train_step import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()                       # the parent's builds, found by their hashes
    outs = []
    for i, job in enumerate(jobs):
        job_t0 = time.perf_counter()
        cfg, rcfg = tp_job_cfg(job)
        data, model = job["shape"]
        v_pad, e_pad = _padded_vocab(cfg, rcfg), sh.padded_experts(cfg, rcfg)
        stream = SyntheticStream.for_arch(cfg, TP_SEQ, TP_BATCH, seed=rcfg.seed)
        batches = {s: stream.get_batch(s) for s in TP_STEPS}
        mesh = make_debug_mesh(data, model, timeout=MESH_TIMEOUT)
        out = {"rank": rank, "coord": (mesh.coord("data"), mesh.coord("model"))}
        times = out["times"] = {}
        ref = {}
        t0 = time.perf_counter()
        if rank == 0:
            # on the card: the gradients at the initial parameters, the
            # parameters after the steps, and the change's squared norm a leaf
            blocked = dataclasses.replace(rcfg, compression=_with_blocks(rcfg.compression, data))
            state = init_train_state(cfg, blocked, device="cuda")
            _fill_gates(state.params, job)
            # ``ref_host``: the reference tensors wait in host memory (a
            # recurrentgemma unit's f32 state fills the card without them),
            # and the initial parameters are drawn again after the steps
            keep = lambda t: t.detach().float().cpu()
            p0 = None if job.get("ref_host") else {
                n: p.detach().clone() for n, p in state.params.named_parameters()}
            _, _, grads = loss_and_grad(cfg, blocked, resolve_for_run(cfg, blocked),
                                        state.params,
                                        batch_to_device(batches[TP_GRAD_STEP], "cuda"),
                                        Key(blocked.seed).fold_in(TP_GRAD_STEP))
            ref["grads"] = {n: (keep(g) if job.get("ref_host") else g.float())
                            for n, g in grads.items()}
            del grads
            out["single_held"] = _held_bytes(p0, ref["grads"])
            undo = _recording_cross_states(out.setdefault("single_cross", []), job)
            state, out["single"] = _mesh_steps(make_train_step(cfg, blocked,
                                                               total_steps=MESH_TOTAL),
                                               state, batches)
            undo()
            out["single_bytes"] = _state_bytes(state)
            out["single_experts"] = _expert_bytes(state)
            out["single_shapes"] = {n: tuple(p.shape) for n, p in state.params.named_parameters()}
            if job.get("ref_host"):
                again = init_model(cfg, blocked, seed=blocked.seed, device="cuda")
                _fill_gates(again, job)
                p0 = dict(again.named_parameters())
                del again
            out["update_den"] = {n: float(torch.linalg.vector_norm(p - p0[n])) ** 2
                                 for n, p in state.params.named_parameters()}
            ref["final"] = {n: (keep(p) if job.get("ref_host") else p.detach())
                            for n, p in state.params.named_parameters()}
            del state, p0
            torch.cuda.empty_cache()
        elif i == 0:
            out["warm_up_s"] = _warm_up()
        dist.barrier()
        times["single-process reference"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = init_distributed_state(cfg, rcfg, mesh, device="cuda")
        _fill_gates(state.params, job)
        torch.cuda.synchronize()
        times["init"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = dict(state.params.named_parameters())
        mine = {k: _ref_slices(ref.get(k), params, mesh, cfg, rcfg, bool(job.get("ref_host")))
                for k in ("grads", "final")}
        del ref
        layout = sh.model_layout(params, cfg, v_pad, e_pad)
        out["split"] = {n for n, cut in layout.items() if cut is not None}
        out["head_parts"] = None if layout.get("head") is None else layout["head"].parts
        out["shapes"] = {n: tuple(p.shape) for n, p in params.items()}
        times["reference slices"] = time.perf_counter() - t0
        out["held"] = _held_bytes(*mine.values())
        hook = _tp_grad_hook(mine.pop("grads"), out, layout, model)
        step_fn = make_shard_map_train_step(cfg, rcfg, total_steps=MESH_TOTAL, mesh=mesh,
                                            grads_hook=hook)
        t0 = time.perf_counter()
        undo = _recording_cross_states(out.setdefault("cross", []), job)
        state, out["mesh"] = _mesh_steps(step_fn, state, batches, mesh.comm)
        undo()
        times["steps"] = time.perf_counter() - t0
        out["bytes"] = _state_bytes(state)
        out["experts"] = _expert_bytes(state)
        out["n_params"] = sum(p.numel() for p in state.params.parameters())
        # the parameters after the steps against the single process's: the
        # squared norm of their difference (this rank's slices) over that of
        # the single process's change (rank 0's, whole leaves)
        out["update_parts"] = _tp_parts(params, mine.pop("final"), layout, model)
        out["lr"] = rcfg.lr
        del mine
        torch.cuda.empty_cache()
        if job["moments"]:
            t0 = time.perf_counter()
            m, _ = gathered_moments(state, mesh, rcfg)
            whole_m = gather_model_(m, layout, sh.make_model_group(mesh, cfg, rcfg, v_pad))
            zero1 = zero1_of(rcfg, mesh, params)
            bad = []
            for n, local in state.opt.m.items():
                want = sh.shard_params({n: whole_m[n]}, mesh, cfg.head_dim, cfg)[n]
                if zero1 is not None:
                    want = sh.shard_slice(want, zero1[0][n], zero1[1], zero1[2])
                if not torch.equal(local, want):
                    bad.append(n)
            out["moment_slices"] = {"leaves": len(state.opt.m), "differ": bad,
                                    "whole_bytes": sum(t.numel() * t.element_size()
                                                       for t in whole_m.values())}
            del m, whole_m
            _free_pinned()
            times["moment gather"] = time.perf_counter() - t0
        del state, step_fn, hook, params
        torch.cuda.empty_cache()
        if job.get("residual_peak"):
            # the same mesh step on the residual structure: its peaks
            t0 = time.perf_counter()
            res_rcfg = dataclasses.replace(rcfg, block_structure="residual")
            state = init_distributed_state(cfg, res_rcfg, mesh, device="cuda")
            step_fn = make_shard_map_train_step(cfg, res_rcfg, total_steps=MESH_TOTAL,
                                                mesh=mesh)
            state, res = _mesh_steps(step_fn, state, {s: batches[s] for s in TP_STEPS[:2]})
            out["residual_peak"], out["residual_loss"] = res["peak"], res["loss"]
            del state, step_fn
            torch.cuda.empty_cache()
            times["residual steps"] = time.perf_counter() - t0
        dist.barrier()
        if rank == 0:   # progress while the group runs (its report comes at the end)
            print(f"[tp] rank 0 done with job {i} ({job['shape']}, {cfg.name} "
                  f"{cfg.n_layers} layers): losses {out['mesh']['loss']}, ms "
                  f"{[round(x) for x in out['mesh']['ms']]}, job wall "
                  f"{time.perf_counter() - job_t0:.1f} s", flush=True)
        outs.append(out)
    return outs


def report_tp(label: str, job: dict, res: list, smi: str) -> None:
    """Print what each rank of one job measured, and hold the mesh to the
    single-process step: losses, step TP_GRAD_STEP's gradients, the
    parameters' change, the launch counts."""
    import math

    tag = f"[{smi}]"
    data, model = job["shape"]
    cfg, rcfg = tp_job_cfg(job)
    single = res[0]["single"]
    print(f"[{label}] {cfg.name} {cfg.n_layers} layers, {rcfg.compression}, remat "
          f"{rcfg.remat!r}, {rcfg.compute_dtype} "
          f"compute, global batch {TP_BATCH} x {TP_SEQ}, mesh data {data} x model {model} "
          f"({data * model} ranks on cuda:0, gloo); steps {list(TP_STEPS)} (index 0 the "
          f"warm-up, rate 0) {tag}")
    # the peaks less the reference tensors a rank holds on the card through
    # its steps for the comparison (a constant the allocator counts)
    single_peak = max(single["peak"]) - res[0]["single_held"]
    peaks = {r["rank"]: [p - r["held"] for p in r["mesh"]["peak"]] for r in res}
    print(f"[{label}] single-process step (blocks={data}, rank 0 while the others wait): "
          f"losses {single['loss']} | ms {[round(x, 1) for x in single['ms']]} | peak "
          f"{_gib(single_peak)} (less the {_gib(res[0]['single_held'])} of reference tensors "
          f"it holds) | params {_gib(res[0]['single_bytes']['params'])} | moments "
          f"{_gib(res[0]['single_bytes']['moments'])} {tag}")
    want = tp_want_launches(job, cfg)
    for r in res:
        rec = r["mesh"]
        warm = f" (warm-up {r['warm_up_s']:.1f} s before)" if "warm_up_s" in r else ""
        print(f"[{label}] rank {r['rank']} (data {r['coord'][0]}, model {r['coord'][1]}): "
              f"losses {rec['loss']} | grad norms {[round(g, 4) for g in rec['gnorm']]} | ms "
              f"per step {[round(x, 1) for x in rec['ms']]} ({SHARED}; step "
              f"{TP_GRAD_STEP} holds the gradient comparison){warm} | init "
              f"{r['times']['init']:.1f} s | peak {[_gib(p) for p in peaks[r['rank']]]} (less "
              f"the {_gib(r['held'])} of reference slices it holds) | params "
              f"{_gib(r['bytes']['params'])} | moments {_gib(r['bytes']['moments'])} | "
              f"{HOST_NOTE} {_per_step_host(rec, TP_STEPS)} {tag}")
        for s, counts in zip(TP_STEPS, rec["counts"]):
            print(f"[{label}] rank {r['rank']} step {s} launches {counts}")
            check({k: counts.get(k, 0) for k in want} == want,
                  f"{label}: rank {r['rank']} step {s} launches {counts} != {want}")
            wrong = ("_ref",) if rcfg.compute_dtype == "float32" else ("_ref", "_f32")
            check(not any(k.endswith(wrong) for k in counts),
                  f"{label}: a plain version or another dtype's route ran on rank "
                  f"{r['rank']}")
        check(rec["loss"] == res[0]["mesh"]["loss"],
              f"{label}: rank {r['rank']} reports other losses than rank 0")
        check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
              f"{label}: a loss or grad norm is not finite on rank {r['rank']}")
    # hold (module text at EP_LAYERS): None (phases 43-44) every step and
    # leaf; "exact change" (47) likewise but the change only over the
    # leaves no compressed site estimates; "routing" (48) the losses at the
    # initial parameters, the rest printed (its layer check holds the path)
    hold = job.get("hold")
    est = lambda n: n.endswith(_site_leaves(rcfg.compression))
    exact = lambda n: not est(n)
    mesh_loss = res[0]["mesh"]["loss"]
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh_loss, single["loss"])]
    held = rel[:TP_GRAD_STEP + 1] if hold == "routing" else rel
    print(f"[{label}] mesh against the single-process step: losses {mesh_loss} vs "
          f"{single['loss']}, rel {[f'{x:.3e}' for x in rel]} (tol {TOL_MESH_LOSS} on "
          f"{'every step' if held is rel else 'the steps at the initial parameters'}; the "
          f"model ranks draw the single process's generator rows)")
    check(max(held) <= TOL_MESH_LOSS, f"{label}: the mesh's losses part from the single-"
          f"process step's")
    gparts = _tp_whole_parts(res, "grad_parts", label)
    g, g_exact, g_est = (_rel_summary(gparts, keep) for keep in (lambda n: True, exact, est))
    print(f"[{label}] gradients of step {TP_GRAD_STEP} (after the data all-reduce) against "
          f"the single-process step, whole leaves from the model ranks' slices, the "
          f"{g['leaves']} leaves: ||mesh - single|| / ||single|| {g['rel']:.3e} ("
          + ("printed" if hold == "routing" else f"tol {TOL_MESH_GRAD}")
          + f"; worst leaf {g['worst']} {g['worst_rel']:.3e}; the {g_exact['leaves']} leaves "
          f"no compressed site estimates {g_exact['rel']:.3e}, the sites' {g_est['rel']:.3e}) "
          f"| the comparison took {res[0]['grad_cmp_ms']:.1f} ms of rank 0's step")
    check(hold == "routing" or g["rel"] <= TOL_MESH_GRAD,
          f"{label}: the mesh's gradients part from the single-process step's")
    parts = {n: (num, res[0]["update_den"][n])
             for n, (num, _) in _tp_whole_parts(res, "update_parts", label).items()}
    u, u_exact = _rel_summary(parts), _rel_summary(parts, exact)
    by_rel = sorted(parts, key=lambda n: -parts[n][0] / max(parts[n][1], 1e-300))
    print(f"[{label}] parameter change over steps {list(TP_STEPS)}: ||mesh - single|| / "
          f"||single|| {u['rel']:.3e} over every element ("
          + {None: f"tol {TOL_MESH_UPDATE}", "exact change": f"tol {TOL_MESH_UPDATE} on the "
             f"others", "routing": "printed"}[hold]
          + f"; the compressed sites' leaves {_rel_summary(parts, est)['rel']:.3e}, the others "
          f"{u_exact['rel']:.3e}; worst leaves "
          + ", ".join(f"{n} {(parts[n][0] / parts[n][1]) ** 0.5:.3e}" for n in by_rel[:4])
          + f"; lr {res[0]['lr']})")
    for r in res:
        print(f"[{label}] rank {r['rank']} seconds: "
              + ", ".join(f"{k} {v:.1f}" for k, v in r["times"].items()))
    held_change = {None: u, "exact change": u_exact}.get(hold)
    check(held_change is None or held_change["rel"] <= TOL_MESH_UPDATE,
          f"{label}: the parameters' change parts from the single-process step's")
    sb = res[0]["single_bytes"]
    print(f"[{label}] a rank against the single process: params "
          + ", ".join(f"{r['bytes']['params'] / sb['params']:.4f}" for r in res)
          + " | moments " + ", ".join(f"{r['bytes']['moments'] / sb['moments']:.4f}"
                                      for r in res)
          + f" | peak a step: single {_gib(single_peak)}, each rank "
          + ", ".join(_gib(max(peaks[r["rank"]])) for r in res) + f" {tag}")
    if not job.get("leaf_shares"):    # phases 49-50: report_leaf_shares holds every leaf
        check(all(r["bytes"]["params"] / sb["params"] < 1 / model + 0.01 for r in res),
              f"{label}: a rank holds more than its share of the parameters")
    for r in res:
        if "moment_slices" in r:
            ms_ = r["moment_slices"]
            print(f"[{label}] rank {r['rank']}: its {ms_['leaves']} moment leaves against its "
                  f"model then data slices of the gathered whole ({_gib(ms_['whole_bytes'])}): "
                  f"{len(ms_['differ'])} differ")
            check(not ms_["differ"], f"{label}: rank {r['rank']}'s moments are not its slices "
                  f"of the gathered whole: {ms_['differ'][:4]}")


def phase_tensor_parallel(smi, layers=TP_LAYERS, dtp_layers=DTP_LAYERS, dtp_extra=(),
                          tp_extra=()):
    """Phases 43 and 44, each in its own group: model 2 on two ranks at
    ``layers`` layers (None: full depth), then data 2 x model 2 on four ranks
    at ``dtp_layers`` layers with the moments' slices checked; the two
    ranks then run the jobs ``tp_extra`` too, the four ranks the jobs
    ``dtp_extra`` (later phases', reported there: spawns fewer). Returns
    the model-2 results and each extra job's (``dtp_extra``'s, then
    ``tp_extra``'s)."""
    from repro_torch.launch.ranks import run_ranks

    out, extra_res = {}, {}
    for label, shape, n, moments in (("tensor parallel", TP_SHAPE, layers, False),
                                     ("data x model", DTP_SHAPE, dtp_layers, True)):
        job = {"shape": shape, "layers": n, "moments": moments}
        extra = list(dtp_extra if shape == DTP_SHAPE else tp_extra)
        t0 = time.perf_counter()
        got = run_ranks(shape[0] * shape[1], tp_rank, [job] + extra, timeout=MESH_TIMEOUT)
        print(f"[tp] {label}: {shape[0] * shape[1]} ranks, wall "
              f"{time.perf_counter() - t0:.1f} s (spawn, warm-up, single-process step, mesh "
              f"steps and gathers" + (f"; then {len(extra)} later job(s))" if extra else ")"))
        report_tp(label, job, [r[0] for r in got], smi)
        out[label] = [r[0] for r in got]
        extra_res[label] = [[r[i] for r in got] for i in range(1, 1 + len(extra))]
    return out["tensor parallel"], extra_res["data x model"] + extra_res["tensor parallel"]


def tp_kernel_rows(gen, tp_res, smi):
    """Phase 45: K3 / K4 / K5 at a model rank's attention shape (4, 2048,
    8/4, 128), K1 at attn.qkv's whole input and K2 at a rank's dZ columns
    (m 1024 for wq, 512 for wk / wv), each against its plain version, then
    as kernel rows; the launches are rank 0's in phase 43's measured
    steps."""
    import torch

    tag = f"[{smi}]"
    B, L, (H, KV, dh) = TP_BATCH, TP_SEQ, TP_HEADS
    errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    check_k3_k45(gen, B, L, H, KV, dh, 0, None, torch.bfloat16, errs, repeat=True)
    b, n, k = TP_SITE
    errs["K1"], f = check_site_k1(gen, b, n, k, "attn.qkv tp 2")
    errs["K2"] = max(check_site_k2(gen, f, m, k, f"{w} tp 2") for m, w in TP_K2_M)
    del f
    launches = _measured_launches(tp_res)
    rows, _ = site_k1_k2_rows(
        gen, b, n, k, "csim_argmax (K1, attn.qkv's whole input on a model rank)",
        [(m, f"segment_matmul (K2, {w}'s columns on a model rank of 2)") for m, w in TP_K2_M],
        launches, errs)
    att = attention_inputs(gen, B, L, H, KV, dh)
    at = f"a model rank's heads ({B}, {L}, {H}/{KV}, {dh})"
    for kk, name, src, rep in (("K3", "flash_attention_fwd", K3_SOURCE, K3_REPLACES),
                               ("K4", "flash_attention_dq", K45_SOURCE, K4_REPLACES),
                               ("K5", "flash_attention_dkv", K45_SOURCE, K5_REPLACES)):
        rows.append(_kernel_row(f"{name} ({kk}, {at})", src, rep, launches.get(name, 0),
                                errs[kk], *att[kk]))
    del att
    note = f"launches on rank 0 in phase 43's steps {list(MESH_STEPS)}"
    print_rows(rows, [(note, "")] * len(rows), tag)
    torch.cuda.empty_cache()
    return rows


def run_tp_phases(gen, smi, layers=TP_LAYERS, dtp_layers=DTP_LAYERS, dtp_extra=(),
                  tp_extra=()):
    """Phases 43-45 (``layers`` / ``dtp_layers`` cut phases 43 / 44:
    tools/tp_phases.py's rehearsal; ``dtp_extra`` / ``tp_extra``: later
    jobs for phase 44's four ranks and phase 43's two). Returns the kernel
    rows and the extra jobs' results (``dtp_extra``'s, then
    ``tp_extra``'s)."""
    t0 = time.perf_counter()
    res, extra = phase_tensor_parallel(smi, layers, dtp_layers, dtp_extra, tp_extra)
    rows = tp_kernel_rows(gen, res, smi)
    print(f"[tp] phases 43-45 wall {time.perf_counter() - t0:.1f} s")
    return rows, extra


# ---------------------------------------------------------------------------
# the model axis for a compressed row-parallel site and for MoE's experts
# ---------------------------------------------------------------------------
SPLIT_SITE = (TRAIN_BATCH * TRAIN_SEQ, 4096, 16)  # ffn.down's (b, n / tp, k) on a model rank
SPLIT_SPEC = "attn.qkv=pamm(r=1/512);ffn.*=pamm(r=1/512)"
SPLIT_LAYERS = 4                 # phase 47: internlm2 at 4 of 24 layers
# phase 48: granite at 8 of 32 layers. At 32 a rank would hold 6.8 GiB of
# parameters, 13.5 of moments and its slices of the reference's gradients
# and parameters (13.5) besides the step's own: two ranks past 72 GiB
EP_LAYERS = 8
EP_RUN = {"pad_vocab_multiple": 128}   # 49155 -> 49280 rows: the vocabulary splits too
EP_HEADS = (12, 4, 64)           # granite's 24 / 8 heads of 64 on each of 2 model ranks
EP_EXPERTS = MOE_E // 2          # a rank's experts
# pass A against its plain version, of the buffer's max |.|: f32 sums of
# bf16 products in another order
TOL_K1_PARTIAL = 2e-5
TOL_SPLIT = 1e-6   # cs: two column halves summed against the whole rows, f32
# phase 47 holds its losses, step-1 gradients and, over the leaves no
# compressed site estimates, its parameters' change at phase 43's bounds;
# the sites' leaves (ffn.* here, attn.qkv there) part by ~0.1 in bf16 (PAMM's
# arg-max flips on partial sums in another order; phase 43's attn.qkv leaves
# read 9.2e-2) and are printed. Phase 48 holds its losses at the initial
# parameters: past them a MoE step amplifies the ranks' rounding -- at 8192
# tokens a router input that differs by 1e-6 (f32 row-parallel sums) sends
# 4 tokens of layer 0 to another expert (tools/ep_flips.py) and the step's
# gradients part by 1e-2 even in f32 with exact experts -- so its
# gradients and change are printed, and the layer check below holds the
# expert-parallel path on identical inputs
SPLIT_JOBS = ({"shape": (1, 2), "layers": SPLIT_LAYERS, "moments": False, "spec": SPLIT_SPEC,
               "hold": "exact change"},
              {"shape": (1, 2), "arch": MOE_ARCH, "layers": EP_LAYERS, "moments": False,
               "spec": MOE_SPEC, "run": EP_RUN, "hold": "routing"})
# phase 48's layer check: one granite MoE layer at full width on 4 x 2048
# tokens, the experts over two ranks against the whole layer from the same
# inputs and weights (the balance loss in, weight 0.01), relative norms of
# the difference: f32 sums in another order; in bf16 the combine's partial
# sums round apart (bf16 eps 7.8e-3); an expert's weight gradients come
# from the same buffer rows and must agree as f32 does
TOL_EP_LAYER = {"float32": {"out": 1e-5, "dx": 1e-5, "router": 1e-5, "experts": 1e-6},
                "bfloat16": {"out": 1e-2, "dx": 1e-2, "router": 1e-3, "experts": 1e-6}}


def k1_partial_work(b, n, k, itemsize):
    """(flops, bytes) of pass A: the b k dots and the norms; x and c read
    once, the (b, k + 1) f32 buffer written once."""
    return 2.0 * b * n * (k + 1), (b + k) * n * itemsize + 4 * b * (k + 1)


def k1_finish_work(b, k):
    """(flops, bytes) of pass B: a multiply pair and a compare a dot; the
    buffer and the rows read once, cs / idx / norm written once."""
    return 3.0 * b * k, 4 * b * (k + 1) + 4 * k + 12 * b


def _csim_margin_clear(part, idx, margin):
    """Rows whose top-2 |csim| (from a (b, k + 1) buffer) part by more than
    ``margin``: where the arg-max is not a near tie."""
    k = part.shape[1] - 1
    na = part[:, k].sqrt()
    csim = part[:, :k] / (na.clamp_min(1e-20)[:, None] * na[idx].clamp_min(1e-20)[None])
    top2 = csim.abs().topk(2, dim=1).values
    return top2[:, 0] - top2[:, 1] > margin


def phase_split_kernels(gen):
    """Phase 46: K1's split route at ffn.down's shape on a model rank of 2
    (b 8192, n 4096 of 8192, k 16), bf16 and f32: pass A against its plain
    version (two launches bitwise equal), pass B on the plain buffer
    against its plain version (idx equal where the top-2 margin is clear);
    then K1 of the whole rows (f32) against two column halves through pass
    A, summed, and pass B -- the plain versions and the kernels: the same
    idx, cs within 1e-6. Returns the passes' largest errors."""
    import torch

    from repro_torch.kernels.pamm_compress import (csim_argmax_cuda, csim_argmax_ref,
                                                   csim_finish_cuda, csim_finish_ref,
                                                   csim_partial_cuda, csim_partial_ref)

    b, n, k = SPLIT_SITE
    errs = {"pass A": 0.0, "pass B": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn((b, n), gen, dtype)
        idx = torch.randperm(b, generator=gen, device="cuda")[:k]
        c = x[idx].contiguous()
        part, again = csim_partial_cuda(x, c), csim_partial_cuda(x, c)
        ref = csim_partial_ref(x, c)
        e_a = (part - ref).abs().max().item()
        rel_a = e_a / ref.abs().max().item()
        fin, fin2 = csim_finish_cuda(ref, idx), csim_finish_cuda(ref, idx)
        cs_r, f_r, na_r = csim_finish_ref(ref, idx)
        e_cs = (fin[0] - cs_r).abs().max().item()
        e_n = ((fin[2] - na_r).abs() / na_r).max().item()
        clear = _csim_margin_clear(ref, idx, TOL_K1_MARGIN)
        n_bad = int((fin[1][clear] != f_r[clear]).sum())
        same_a = bool(torch.equal(part, again))
        same_b = all(torch.equal(u, v) for u, v in zip(fin, fin2))
        name = str(dtype).split(".")[-1]
        print(f"[K1 split] pass A b={b} n={n} k={k} {name}: max|part-ref|={e_a:.3e} "
              f"({rel_a:.3e} of max|ref|, tol {TOL_K1_PARTIAL}); two launches bitwise "
              f"equal: {same_a} | pass B: max|cs-cs_ref|={e_cs:.3e} max rel |norm err|="
              f"{e_n:.3e} (tol {TOL_K1}); idx equal on {int(clear.sum())}/{b} clear rows "
              f"({n_bad} differ); two launches bitwise equal: {same_b}")
        check(rel_a <= TOL_K1_PARTIAL and same_a,
              f"K1 pass A disagrees with its plain version ({name}) or is not deterministic")
        check(e_cs <= TOL_K1 and e_n <= TOL_K1 and n_bad == 0 and same_b,
              f"K1 pass B disagrees with its plain version ({name}) or is not deterministic")
        errs["pass A"] = max(errs["pass A"], e_a)
        errs["pass B"] = max(errs["pass B"], e_cs)
        del part, again, ref, fin, fin2
    # split equals whole (f32): the plain passes and the kernels
    h = n // 2
    halves = [(x[:, :h].contiguous(), c[:, :h].contiguous()),
              (x[:, h:].contiguous(), c[:, h:].contiguous())]
    for route, partial, finish, whole in (
            ("plain", csim_partial_ref, csim_finish_ref, csim_argmax_ref),
            ("kernels", csim_partial_cuda, csim_finish_cuda, csim_argmax_cuda)):
        summed = sum(partial(xh, ch) for xh, ch in halves)
        cs, f, na = finish(summed, idx)
        cs_w, f_w, na_w = whole(x, c)
        # the plain passes against the plain K1: the same f32 sums split in
        # two; the kernels against K1's kernel: each is held to TOL_K1
        tol = TOL_SPLIT if route == "plain" else TOL_K1
        clear = _csim_margin_clear(summed, idx, tol)
        e_cs = (cs - cs_w).abs().max().item()
        n_bad = int((f[clear] != f_w[clear]).sum())
        print(f"[K1 split] {route}: two column halves of {h} through pass A, summed, then "
              f"pass B, against K1 on the whole rows (f32): max|cs-cs_whole|={e_cs:.3e} (tol "
              f"{tol}); idx equal on {int(clear.sum())}/{b} rows with a top-2 margin > "
              f"{tol} ({n_bad} differ); max rel |norm err|="
              f"{((na - na_w).abs() / na_w).max().item():.3e}")
        check(e_cs <= tol and n_bad == 0,
              f"K1's split route ({route}) on column halves parts from K1 on the whole rows")
    del x, c, halves
    torch.cuda.empty_cache()
    return errs


def report_split_bytes(label: str, res: list, smi: str) -> None:
    """Phase 47's row-site traffic: per rank and step, the card <-> host
    bytes of the split route's (b, k + 1) buffers against the model
    all-reduces' (gloo's own copies)."""
    tag = f"[{smi}]"
    for r in res:
        row = [h.get("row_site_all_reduce", 0) for h in r["mesh"]["host"]]
        tp = [h.get("model_all_reduce", 0) for h in r["mesh"]["host"]]
        print(f"[{label}] rank {r['rank']} row-site all-reduce (K1 split buffers) "
              f"{[b / 2**20 for b in row]} MiB a step vs the model all-reduces "
              f"{[round(b / 2**30, 4) for b in tp]} GiB: "
              + ", ".join(f"{a / max(b, 1):.3%}" for a, b in zip(row, tp)) + f" {tag}")
        check(all(b > 0 for b in row),
              f"{label}: rank {r['rank']} sent no K1 split buffer over the model group")


def report_experts(label: str, res: list, smi: str) -> None:
    """Phase 48's expert leaves: a rank's parameter and moment bytes of
    them against the single process's (half each)."""
    tag = f"[{smi}]"
    single = res[0]["single_experts"]
    for r in res:
        e = r["experts"]
        print(f"[{label}] rank {r['rank']} expert leaves: params {_gib(e['params'])} "
              f"({e['params'] / single['params']:.4f} of one process's), moments "
              f"{_gib(e['moments'])} ({e['moments'] / single['moments']:.4f}) {tag}")
        check(abs(e["params"] / single["params"] - 0.5) < 1e-6
              and abs(e["moments"] / single["moments"] - 0.5) < 1e-6,
              f"{label}: rank {r['rank']} does not hold half of the experts")


def ep_layer_check(rank: int) -> dict:
    """Phase 48's layer check on model rank ``rank`` of two (module text at
    TOL_EP_LAYER): {dtype: {what: ||ep - whole|| / ||whole||}} of the
    layer's output, the input's, the router's and this rank's experts'
    gradients."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe
    from repro_torch.runtime import sharding as sh

    cfg = get_config(MOE_ARCH)
    mg = sh.make_model_group(make_debug_mesh(1, 2, timeout=MESH_TIMEOUT), cfg, RunConfig(),
                             cfg.vocab_size)
    e = MOE_E // 2
    mine = slice(rank * e, (rank + 1) * e)
    out = {}
    for name in TOL_EP_LAYER:
        dt = getattr(torch, name)
        gen = torch.Generator(device="cuda").manual_seed(7)
        whole = moe.init_moe(gen, cfg, dt)
        x = _randn((TP_BATCH * TP_SEQ, cfg.d_model), gen, dt)
        w = _randn(x.shape, gen, dt)
        got = {}
        for split in (False, True):
            p = {k: v.clone().requires_grad_() for k, v in whole.items()}
            xx = x.clone().requires_grad_()
            local = {k: (v[mine] if k.startswith("w_") else v) for k, v in p.items()} \
                if split else p
            with sh.tensor_parallel(mg if split else None):
                o, aux = moe.moe_ffn(local, xx, cfg)
                ((o.float() * w.float()).sum() + 0.01 * aux).backward()
            got[split] = {"out": o.detach().float(), "dx": xx.grad.float(),
                          "router": p["router"].grad.float(),
                          "experts": torch.cat([p[k].grad[mine].float().reshape(-1)
                                                for k in ("w_gate", "w_up", "w_down")])}
            del p, xx, local, o
        out[name] = {k: float((got[True][k] - v).norm() / v.norm()) for k, v in got[False].items()}
        del whole, x, w, got
        torch.cuda.empty_cache()
    return out


def split_rank(rank: int, world: int, jobs: list) -> list:
    """A rank of phases 47-48: :func:`tp_rank`'s jobs, then the layer check."""
    return tp_rank(rank, world, jobs) + [ep_layer_check(rank)]


def report_ep_layer(res: list, smi: str) -> None:
    for rank, r in enumerate(res):
        for name, rels in r.items():
            tol = TOL_EP_LAYER[name]
            print(f"[expert parallel layer] granite's MoE layer at full width, {TP_BATCH} x "
                  f"{TP_SEQ} tokens, {name}, rank {rank}'s 20 of 40 experts against the "
                  f"whole layer: " + ", ".join(f"{k} {v:.2e} (tol {tol[k]})"
                                               for k, v in rels.items()) + f" [{smi}]")
            check(all(v <= tol[k] for k, v in rels.items()),
                  f"expert parallel layer ({name}): rank {rank} parts from the whole layer")


def phase_split_and_experts(smi, jobs=SPLIT_JOBS, later=()):
    """Phases 47 and 48 in one group of two ranks: internlm2 under
    SPLIT_SPEC (ffn.down through K1's split route), then granite under
    MOE_SPEC with its experts over the model axis, each against the
    single-process step; then the jobs ``later`` (a later phase's,
    reported there: one spawn of two ranks fewer); then the layer check.
    Returns each of ``jobs``' results and each extra job's."""
    from repro_torch.launch.ranks import run_ranks

    t0 = time.perf_counter()
    res = run_ranks(2, split_rank, list(jobs) + list(later), timeout=MESH_TIMEOUT)
    print(f"[tp] phases 47-48: 2 ranks, wall {time.perf_counter() - t0:.1f} s (spawn, "
          f"warm-up, the single-process steps, mesh steps, the layer check"
          + (f"; and {len(later)} later job(s))" if later else ")"))
    out = []
    for i, (label, extra) in enumerate((("row-parallel ffn.down", report_split_bytes),
                                        ("expert parallel", report_experts))):
        job_res = [r[i] for r in res]
        report_tp(label, jobs[i], job_res, smi)
        extra(label, job_res, smi)
        out.append(job_res)
    report_ep_layer([r[-1] for r in res], smi)
    return out, [[r[len(jobs) + i] for r in res] for i in range(len(later))]


def split_and_expert_rows(gen, errs, res47, res48, smi):
    """Kernel rows of phases 46-48: K1's passes at ffn.down's rank shape
    (launches: rank 0's in phase 47's measured steps); the batched K1 / K2
    at a rank's 20 experts (each checked against its plain version here)
    and K3 / K4 / K5 at a rank's granite heads (4, 2048, 12/4, 64),
    launches rank 0's in phase 48's measured steps."""
    import torch

    from repro_torch.kernels.pamm_apply import (segment_matmul_batched_cuda,
                                                segment_matmul_batched_ref)
    from repro_torch.kernels.pamm_compress import (csim_argmax_batched_cuda,
                                                   csim_argmax_batched_ref, csim_finish_cuda,
                                                   csim_finish_ref, csim_partial_cuda,
                                                   csim_partial_ref)

    tag = f"[{smi}]"

    def measured(res):
        out = {}
        for s, counts in zip(TP_STEPS, res[0]["mesh"]["counts"]):
            if s in MESH_STEPS:
                for name, c in counts.items():
                    out[name] = out.get(name, 0) + c
        return out

    l47, l48 = measured(res47), measured(res48)
    b, n, k = SPLIT_SITE
    x = _randn((b, n), gen)
    idx = torch.randperm(b, generator=gen, device="cuda")[:k]
    c = x[idx].contiguous()
    part = csim_partial_ref(x, c)
    rows = [_kernel_row("csim_partial (K1 split route, pass A: ffn.down's column slice on a "
                        "model rank of 2)", K1_SOURCE, K1_REPLACES, l47.get("csim_partial", 0),
                        errs["pass A"], lambda: csim_partial_cuda(x, c),
                        lambda: csim_partial_ref(x, c), None, k1_partial_work(b, n, k, 2)),
            _kernel_row("csim_finish (K1 split route, pass B: the arg-max from the summed "
                        "dots)", K1_SOURCE, K1_REPLACES, l47.get("csim_finish", 0),
                        errs["pass B"], lambda: csim_finish_cuda(part, idx),
                        lambda: csim_finish_ref(part, idx), None, k1_finish_work(b, k))]
    at47 = "launches on rank 0 in phase 47's steps " + str(list(MESH_STEPS))
    notes = [(at47, f" at ({b}, {n}, k {k})"), (at47, f" at ({b}, k {k})")]
    del x, c, part
    E, cap, d, f_w, kk = EP_EXPERTS, MOE_CAP, MOE_D, MOE_F, MOE_K
    xs, cs = moe_site_inputs(gen, E, cap, d, kk)
    out = csim_argmax_batched_cuda(xs, cs)
    ref = csim_argmax_batched_ref(xs, cs)
    e_k1 = (out[0].abs() - ref[0].abs()).abs().max().item()
    check(e_k1 <= TOL_K1, f"the batched K1 at a rank's {E} experts: |cs| error {e_k1:.3e}")
    f = out[1]
    alpha = torch.randn((E, cap), generator=gen, device="cuda")
    gz = _randn((E, cap, f_w), gen)
    b2, b2r = segment_matmul_batched_cuda(f, alpha, gz, kk), segment_matmul_batched_ref(
        f, alpha, gz, kk)
    e_k2 = (b2 - b2r).abs().max().item()
    check(e_k2 <= TOL_K2 * b2r.abs().max().item(),
          f"the batched K2 at a rank's {E} experts: error {e_k2:.3e}")
    print(f"[K1/K2 batched] a rank's {E} experts: K1 max||cs|-|cs_ref||={e_k1:.3e} (tol "
          f"{TOL_K1}), K2 max|B-B_ref|={e_k2:.3e} (tol {TOL_K2} x {b2r.abs().max().item():.1f})")
    w1, w2 = k1_work(cap, d, kk, 2), k2_work(cap, f_w, kk, 2)
    at48 = "launches on rank 0 in phase 48's steps " + str(list(MESH_STEPS))
    rows += [_kernel_row(f"csim_argmax_batched (K1, a model rank's {E} of {MOE_E} experts)",
                         K1_SOURCE, K1_REPLACES, l48.get("csim_argmax_batched", 0), e_k1,
                         lambda: csim_argmax_batched_cuda(xs, cs),
                         lambda: csim_argmax_batched_ref(xs, cs), None,
                         (E * w1[0], E * w1[1])),
             _kernel_row(f"segment_matmul_batched (K2, a model rank's {E} of {MOE_E} experts)",
                         K2_SOURCE, K2_REPLACES, l48.get("segment_matmul_batched", 0), e_k2,
                         lambda: segment_matmul_batched_cuda(f, alpha, gz, kk),
                         lambda: segment_matmul_batched_ref(f, alpha, gz, kk), None,
                         (E * w2[0], E * w2[1]))]
    notes += [(at48, f" at ({E} x {cap}, {d}, k {kk})"), (at48, f" at ({E} x {cap}, m {f_w}, "
                                                                 f"k {kk})")]
    del xs, cs, gz, out, ref, b2, b2r
    B, L, (H, KV, dh) = TP_BATCH, TP_SEQ, EP_HEADS
    errs3 = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    check_k3_k45(gen, B, L, H, KV, dh, 0, None, torch.bfloat16, errs3)
    att = attention_inputs(gen, B, L, H, KV, dh)
    at = f"a model rank's granite heads ({B}, {L}, {H}/{KV}, {dh})"
    for kern, name, src, rep in (("K3", "flash_attention_fwd", K3_SOURCE, K3_REPLACES),
                                 ("K4", "flash_attention_dq", K45_SOURCE, K4_REPLACES),
                                 ("K5", "flash_attention_dkv", K45_SOURCE, K5_REPLACES)):
        rows.append(_kernel_row(f"{name} ({kern}, {at})", src, rep, l48.get(name, 0),
                                errs3[kern], *att[kern]))
        notes.append((at48, ""))
    del att
    print_rows(rows, notes, tag)
    torch.cuda.empty_cache()
    return rows


def run_split_and_expert_phases(gen, smi, jobs=SPLIT_JOBS, extra=()):
    """Phases 46-48 (``jobs``: tools/tp_phases.py cuts their depth;
    ``extra``: later jobs for their two ranks). Returns the kernel rows and
    the extra jobs' results."""
    t0 = time.perf_counter()
    errs = phase_split_kernels(gen)
    (res47, res48), extra_res = phase_split_and_experts(smi, jobs, extra)
    rows = split_and_expert_rows(gen, errs, res47, res48, smi)
    print(f"[tp] phases 46-48 wall {time.perf_counter() - t0:.1f} s")
    return rows, extra_res


# ---------------------------------------------------------------------------
# the model axis for the ssm and rec / latt kinds
# ---------------------------------------------------------------------------
# phase 49: mamba2-370m over model 2 (a rank's 16 of 32 heads, B / C whole),
# phase 50: one (rec, rec, latt) unit of recurrentgemma-9b at full width over
# model 2 (its RG-LRU width, 8 of latt's 16 q heads, its one K/V head whole,
# its FFN and vocabulary), each against the single-process step at phase
# 43's bounds (the parameters' change over the leaves no compressed site
# estimates, the sites' printed, as phase 47)
# phase 49 runs two model-2 jobs: bf16 compute at 12 of 48 layers, and f32
# compute at full depth. In bf16 the model ranks round what one process
# does not (a row-parallel product's partial sums, a column-parallel
# input's partial gradients), and the gap grows with depth: on an H100
# the step-1 gradients parted by 3.428e-2 at 12 layers and by 8.585e-2 at
# 48 (tol 0.05; losses 1.213e-5 to 4.803e-5). The f32 job holds the same
# checks at full depth, where only the order of the sums differs.
SSM_TP_LAYERS = 12
SSM_DTP_LAYERS = 4               # phase 49's data 2 x model 2 job (ZeRO-1's moments)
SSM_TP_JOB = {"shape": (1, 2), "arch": SSM_ARCH, "layers": SSM_TP_LAYERS, "moments": False,
              "spec": SSM_SPEC, "run": {"remat": SSM_REMAT}, "hold": "exact change",
              "leaf_shares": ("ssm.in_proj", "ssm.conv_w", "ssm.out_norm", "ssm.out_proj")}
REC_TP_JOB = {"shape": (1, 2), "arch": REC_ARCH, "stages": REC_CUT_STAGES, "moments": False,
              "spec": REC_SPEC, "run": {"remat": REC_REMAT}, "hold": "exact change",
              "ref_host": True,
              "leaf_shares": ("rec.w_x", "rec.w_y", "rec.w_a", "rec.out", "attn.wq", "attn.wk",
                              "ffn.w_gate", "embed", "head")}
SSM_TP_F32_JOB = {**SSM_TP_JOB, "layers": None, "label": "ssm tensor parallel f32",
                  "run": {"remat": SSM_REMAT, "compute_dtype": "float32"}}
KIND_TP_JOBS = (SSM_TP_JOB, SSM_TP_F32_JOB, REC_TP_JOB)


def ssm_dtp_job(layers=SSM_DTP_LAYERS) -> dict:
    """Phase 49's data 2 x model 2 job: mamba2 at ``layers`` layers, the
    moments' slices checked. chip_smoke.py runs it on phase 44's four
    ranks, tools/tp_phases.py on four of its own."""
    return {**SSM_TP_JOB, "shape": DTP_SHAPE, "layers": layers, "moments": True}
# phase 51: K1 on the whole rows of ssm.in (n 1024) and rglru.in (n 4096); K2
# at a rank's columns: ssm.in's 1024 z + 1024 x + 128 B + 128 C + 16 dt,
# rglru.in's 2048 (and latt's wq; wk / wv 256 whole); K3-K5 at a rank's latt
# heads, window 2048
SSM_TP_M = 2 * SSM_D + 2 * 128 + 16
REC_TP_M = REC_D // 2
REC_TP_HEADS = (8, 1, 256)


def tp_kind_launches(job: dict, cfg) -> dict:
    """Launches a model rank's step makes on the ssm / rec path: K1 once a
    layer (under remat='pamm' the recompute takes the kept state) and K2
    once (ssm.in, rglru.in) or three times (latt's wq / wk / wv); K3 once
    a latt layer, twice under remat, K4 and K5 once."""
    _, rcfg = tp_job_cfg(job)
    kinds = [k for unit, rep in cfg.stages for _ in range(rep) for k in unit]
    att = kinds.count("latt")
    want = {"csim_argmax": len(kinds),
            "segment_matmul": sum(3 if k == "latt" else 1 for k in kinds)}
    if att:
        want.update(flash_attention_fwd=att * (1 if rcfg.remat == "none" else 2),
                    flash_attention_dq=att, flash_attention_dkv=att)
    return want


def report_leaf_shares(label: str, job: dict, res: list, smi: str) -> None:
    """Every leaf a rank holds is the shape its model-axis cut gives the
    single process's leaf (``runtime.sharding.model_cut``); the named
    leaves' share of the whole printed (``in_proj`` keeps B / C whole)."""
    import math

    from repro_torch.runtime import sharding as sh

    cfg, _ = tp_job_cfg(job)
    tp = job["shape"][1]
    whole = res[0]["single_shapes"]
    bad = []
    for r in res:
        for n, shape in r["shapes"].items():
            cut = sh.model_cut(n, whole[n], tp, cfg.head_dim, cfg)
            want = list(whole[n])
            if cut is not None:
                want[cut.dim] = cut.local_size(tp)
            if tuple(want) != shape:
                bad.append((r["rank"], n, shape, tuple(want)))
    shares = []
    for suffix in job["leaf_shares"]:
        names = [n for n in whole if n.endswith(suffix)]
        num = sum(math.prod(res[0]["shapes"][n]) for n in names)
        shares.append(f"{suffix} {num / sum(math.prod(whole[n]) for n in names):.4f}")
    print(f"[{label}] rank 0's share of the whole leaf, by bytes: " + ", ".join(shares)
          + f"; {len(bad)} of {len(whole)} leaves on {len(res)} ranks differ from their cut "
          f"[{smi}]")
    check(not bad, f"{label}: a rank's leaf is not its cut of the whole: {bad[:3]}")


def phase_kind_tensor_parallel(smi, jobs=KIND_TP_JOBS, dtp_layers=SSM_DTP_LAYERS,
                               dtp_res=None, res=None):
    """Phases 49 and 50 (``jobs``: mamba2's, then recurrentgemma's unit):
    their results ``res`` when phases 47-48's ranks ran them, else in a
    group of two ranks; then phase 49's data 2 x model 2 job: its results
    ``dtp_res`` when phase 44's ranks ran it, else (unless ``dtp_layers``
    is 0) on four ranks at ``dtp_layers`` layers. Returns each model-2
    job's results."""
    from repro_torch.launch.ranks import run_ranks

    if res is None:
        t0 = time.perf_counter()
        got = run_ranks(2, tp_rank, list(jobs), timeout=MESH_TIMEOUT)
        res = [[r[i] for r in got] for i in range(len(jobs))]
        print(f"[tp] phases 49-50: 2 ranks, wall {time.perf_counter() - t0:.1f} s (spawn, "
              f"warm-up, the single-process steps, mesh steps)")
    out = []
    for job, job_res in zip(jobs, res):
        label = job.get("label") or ("ssm tensor parallel" if job["arch"] == SSM_ARCH
                                     else "rec tensor parallel")
        report_tp(label, job, job_res, smi)    # its rank lines: the collectives' bytes
        report_leaf_shares(label, job, job_res, smi)
        out.append(job_res)
    if dtp_res is not None or dtp_layers:
        job = ssm_dtp_job(dtp_layers or SSM_DTP_LAYERS)
        if dtp_res is None:
            t0 = time.perf_counter()
            dtp_res = [r[0] for r in run_ranks(4, tp_rank, [job], timeout=MESH_TIMEOUT)]
            print(f"[tp] phase 49, data x model: 4 ranks, wall "
                  f"{time.perf_counter() - t0:.1f} s")
        report_tp("ssm data x model", job, dtp_res, smi)
        report_leaf_shares("ssm data x model", job, dtp_res, smi)
    return out


def _measured_launches(res) -> dict:
    """Rank 0's launches summed over a tensor-parallel job's measured steps."""
    out = {}
    for s, counts in zip(TP_STEPS, res[0]["mesh"]["counts"]):
        if s in MESH_STEPS:
            for name, c in counts.items():
                out[name] = out.get(name, 0) + c
    return out


def kind_kernel_rows(gen, res49, res50, smi):
    """Phase 51: K1 on the whole rows of ssm.in (8192, 1024, k 16) and of
    rglru.in (8192, 4096, k 16), K2 at a model rank's columns of them (m
    2320 and 2048), K3 / K4 / K5 at a rank's latt heads (4, 2048, 8/1,
    256), window 2048, each against its plain version, then as kernel
    rows (SDPA's forward and backward for K3-K5); the launches are rank
    0's in phases 49 / 50's measured steps."""
    import torch

    tag = f"[{smi}]"
    l49, l50 = _measured_launches(res49), _measured_launches(res50)
    b, k = TRAIN_BATCH * TRAIN_SEQ, SSM_K
    rows, notes = [], []
    for n, m, launches, phase, site in ((SSM_D, SSM_TP_M, l49, 49, "ssm.in"),
                                        (REC_D, REC_TP_M, l50, 50, "rglru.in")):
        errs = {}
        errs["K1"], f = check_site_k1(gen, b, n, k, f"{site} tp 2")
        errs["K2"] = check_site_k2(gen, f, m, k, f"{site} tp 2")
        del f
        what = "" if phase == 49 else " and latt's attn.qkv (wq at m 2048, wk / wv 256)"
        got, _ = site_k1_k2_rows(
            gen, b, n, k, f"csim_argmax (K1, {site}'s whole rows on a model rank{what})",
            [(m, f"segment_matmul (K2, {site}'s columns on a model rank of 2{what})")],
            launches, errs)
        rows += got
        note = f"launches on rank 0 in phase {phase}'s steps {list(MESH_STEPS)}"
        notes += [(note, f" at ({b}, {n}, k {k})"), (note, f" at ({b}, m {m}, k {k})")]
        torch.cuda.empty_cache()
    B, L, (H, KV, dh), W = TP_BATCH, TP_SEQ, REC_TP_HEADS, REC_WINDOW
    errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    check_k3_k45(gen, B, L, H, KV, dh, W, None, torch.bfloat16, errs)
    att = attention_inputs(gen, B, L, H, KV, dh, W)
    at = f"a model rank's latt heads ({B}, {L}, {H}/{KV}, {dh}), window {W}"
    for kern, name, src, rep in (("K3", "flash_attention_fwd", K3_SOURCE, K3_REPLACES),
                                 ("K4", "flash_attention_dq", K45_SOURCE, K4_REPLACES),
                                 ("K5", "flash_attention_dkv", K45_SOURCE, K5_REPLACES)):
        rows.append(_kernel_row(f"{name} ({kern}, {at})", src, rep, l50.get(name, 0),
                                errs[kern], *att[kern]))
        notes.append((f"launches on rank 0 in phase 50's steps {list(MESH_STEPS)}", ""))
    del att
    print_rows(rows, notes, tag)
    torch.cuda.empty_cache()
    return rows


def run_kind_tp_phases(gen, smi, jobs=KIND_TP_JOBS, dtp_layers=SSM_DTP_LAYERS, dtp_res=None,
                       res=None):
    """Phases 49-51 (``jobs`` / ``dtp_layers``: tools/tp_phases.py cuts
    their depth; ``res`` / ``dtp_res``: phases 49-50's jobs as phases
    47-48's ranks ran them, phase 49's data x model job as phase 44's).
    Returns the kernel rows."""
    t0 = time.perf_counter()
    res = phase_kind_tensor_parallel(smi, jobs, dtp_layers, dtp_res, res)
    rows = kind_kernel_rows(gen, res[0], res[-1], smi)
    print(f"[tp] phases 49-51 wall {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# the model axis for the xattn kind, musicgen's codebooks and reversible blocks
# ---------------------------------------------------------------------------
# phase 52: one (attn x 4, xattn) unit of llama-3.2-vision-11b at full width
# (5 of 40 layers, as the vision training phase; 2.14 B parameters), gates
# filled, over model 2: a rank's 16 / 4 heads in every block, 7168 of d_ff,
# 64128 vocabulary rows, the image rows whole. One process's f32 state is
# 8.6 GB of parameters, 8.6 of gradients and 17.1 of moments, with the
# step's activations and AdamW's temporaries some 45-55 GB; its reference
# gradients and initial parameters (17.1 GB more) would pass 70 GB, so
# they wait in host memory (``ref_host``, as phase 50). Two ranks then
# hold about 17 GB of state each.
# phase 53: musicgen-medium at full width, 12 of 48 layers (a time cut: the
# ranks' steps cost their gloo all-reduces, ~1.8 GB a step at 12 layers),
# under remat='pamm'; a rank holds 12 / 12 heads and 1024 of each
# codebook's 2048 head columns, four parts (runtime.sharding.head_parts).
# phase 54: internlm2-1.8b at 4 layers, reversible blocks, f32 compute (the
# streams rebuild exactly only in f32: K3-K5 and K1 take their f32 routes)
# against the single-process reversible step; then the residual model-2
# step of the same run, for its peak.
# Each is held to the single process at phase 43's bounds over every leaf.
VIS_TP_JOB = {"shape": (1, 2), "arch": VIS_ARCH, "stages": VIS_TRAIN_STAGES, "moments": False,
              "spec": VIS_SPEC, "run": {"remat": VIS_REMAT}, "gates": VIS_GATE,
              "cross_rows": TP_BATCH * VIS_TOKENS, "ref_host": True,
              "label": "vision tensor parallel",
              "leaf_shares": ("attn.wq", "attn.wk", "attn.gate_attn", "ffn.w_gate", "embed",
                              "head")}
AUDIO_TP_LAYERS = 12
AUDIO_TP_JOB = {"shape": (1, 2), "arch": AUDIO_ARCH, "layers": AUDIO_TP_LAYERS,
                "moments": False, "spec": AUDIO_SPEC, "run": {"remat": AUDIO_REMAT},
                "label": "audio tensor parallel",
                "leaf_shares": ("attn.wq", "ffn.w_gate", "head")}
REV_TP_LAYERS = 4
REV_TP_JOB = {"shape": (1, 2), "layers": REV_TP_LAYERS, "moments": False,
              "run": {"remat": "none", "block_structure": "reversible",
                      "compute_dtype": "float32"},
              "residual_peak": True, "label": "reversible tensor parallel",
              "leaf_shares": ("attn.wq", "ffn.w_gate", "head")}
XAR_TP_JOBS = (VIS_TP_JOB, AUDIO_TP_JOB, REV_TP_JOB)
# phase 55: K3-K5 at a vision rank's and a musicgen rank's heads; K1 on the
# attn.cross_kv site's whole image rows, K2 at a rank's wk / wv columns
VIS_TP_HEADS = (16, 4, 128)
AUDIO_TP_HEADS = (12, 12, 64)
VIS_TP_CROSS_M = VIS_CROSS_M // 2
AUDIO_TP_M = AUDIO_TP_HEADS[0] * AUDIO_TP_HEADS[2]    # a rank's wq / wk / wv columns


def tp_attn_launches(job: dict, cfg) -> dict:
    """Launches of a model rank's attention layers in a step: K1 once a
    site a layer (attn.qkv; an xattn layer's attn.cross_kv too), twice
    under reversible blocks (the forward compresses for the telemetry,
    the backward's recompute for the gradient); K2 once a compressed
    weight (wq, wk, wv); K3 in each self-attention layer's forward and
    again in a recompute (remat or reversible), K4 and K5 once; the
    attention kernels' f32 routes under f32 compute."""
    _, rcfg = tp_job_cfg(job)
    kinds = [k for unit, rep in cfg.stages for _ in range(rep) for k in unit]
    att = sum(k in ("attn", "swa", "moe") for k in kinds)
    x = kinds.count("xattn")
    rev = rcfg.block_structure != "residual"
    sfx = "_f32" if rcfg.compute_dtype == "float32" else ""
    return {"csim_argmax": (2 if rev else 1) * (att + 2 * x),
            "segment_matmul": 3 * (att + x),
            "flash_attention_fwd" + sfx: (2 if rev or rcfg.remat != "none" else 1) * att,
            "flash_attention_dq" + sfx: att, "flash_attention_dkv" + sfx: att}


def report_xar(job: dict, res: list, smi: str) -> None:
    """What phases 52-54 hold besides phase 43's checks: the attn.cross_kv
    states equal on both ranks and to one process's, a rank's head in its
    codebook parts, the reversible peak beside the residual one."""
    import math

    from repro_torch.models.model import _padded_vocab

    cfg, rcfg = tp_job_cfg(job)
    label, tag = job["label"], f"[{smi}]"
    if job.get("cross_rows"):
        single = res[0]["single_cross"]
        same = all(r["cross"] == single for r in res)
        print(f"[{label}] attn.cross_kv states ({job['cross_rows']} image rows, one a step): "
              f"{len(single)} a process; both ranks' equal to each other and to one "
              f"process's bit for bit: {same}")
        check(bool(single) and same, f"{label}: the model ranks' attn.cross_kv states differ")
    want = ((cfg.vocab_size,) * cfg.n_codebooks if cfg.n_codebooks
            else (_padded_vocab(cfg, rcfg),))
    parts = [r["head_parts"] for r in res]
    print(f"[{label}] a rank's head: parts {parts[0]} of the whole's {cfg.n_codebooks or 1} "
          f"codebook(s) of {want[0]} columns")
    check(all(p == tuple((v, True) for v in want) for p in parts),
          f"{label}: a rank's head is not its share of each codebook: {parts}")
    if job.get("residual_peak"):
        for r in res:
            rev, resid = max(r["mesh"]["peak"]) - r["held"], max(r["residual_peak"])
            print(f"[{label}] rank {r['rank']}: peak a step, reversible {_gib(rev)} (less its "
                  f"reference slices) vs the residual model-2 step's {_gib(resid)} "
                  f"({cfg.n_layers} layers, f32; residual losses {r['residual_loss']}) {tag}")
            check(all(math.isfinite(x) for x in r["residual_loss"]),
                  f"{label}: the residual model-2 step's losses are not finite")


def phase_xar_tensor_parallel(smi, jobs=XAR_TP_JOBS, res=None):
    """Phases 52-54: their results ``res`` when phase 43's ranks ran them,
    else in a group of two ranks. Returns each job's results."""
    from repro_torch.launch.ranks import run_ranks

    if res is None:
        t0 = time.perf_counter()
        got = run_ranks(2, tp_rank, list(jobs), timeout=MESH_TIMEOUT)
        res = [[r[i] for r in got] for i in range(len(jobs))]
        print(f"[tp] phases 52-54: 2 ranks, wall {time.perf_counter() - t0:.1f} s (spawn, "
              f"warm-up, the single-process steps, mesh steps)")
    for job, job_res in zip(jobs, res):
        report_tp(job["label"], job, job_res, smi)
        report_leaf_shares(job["label"], job, job_res, smi)
        report_xar(job, job_res, smi)
    return res


def xar_kernel_rows(gen, res52, res53, smi):
    """Phase 55: K1 on attn.cross_kv's whole image rows (6404, 4096, k 13)
    and K2 at a rank's wk / wv columns (m 512), K3 / K4 / K5 at a vision
    rank's heads (4, 2048, 16/4, 128) and a musicgen rank's (4, 2048,
    12/12, 64), each against its plain version, then as kernel rows (SDPA
    as the library for K3-K5); K1 at musicgen's attn.qkv with K2 at a
    rank's m 768, and the f32 routes of K3-K5 at phase 54's (4, 2048, 8/4,
    128), against their plain versions. The launches are rank 0's in
    phases 52 / 53's measured steps."""
    import torch

    tag = f"[{smi}]"
    l52, l53 = _measured_launches(res52), _measured_launches(res53)
    b, n, k = VIS_CROSS_B, VIS_D, VIS_CROSS_K
    errs = {}
    errs["K1"], f = check_site_k1(gen, b, n, k, "attn.cross_kv tp 2")
    errs["K2"] = check_site_k2(gen, f, VIS_TP_CROSS_M, k, "attn.cross_kv tp 2")
    del f
    note52 = f"launches on rank 0 in phase 52's steps {list(MESH_STEPS)}"
    note53 = f"launches on rank 0 in phase 53's steps {list(MESH_STEPS)}"
    rows, _ = site_k1_k2_rows(
        gen, b, n, k, "csim_argmax (K1, attn.cross_kv's whole image rows on a model rank)",
        [(VIS_TP_CROSS_M, "segment_matmul (K2, attn.cross_kv's wk / wv columns on a model "
                          "rank of 2)")], l52, errs)
    notes = [(note52 + ", every site", f" at ({b}, {n}, k {k})"),
             (note52 + ", every site", f" at ({b}, m {VIS_TP_CROSS_M}, k {k})")]
    torch.cuda.empty_cache()
    _, f = check_site_k1(gen, TRAIN_BATCH * TRAIN_SEQ, AUDIO_D, AUDIO_K, "musicgen attn.qkv tp 2")
    check_site_k2(gen, f, AUDIO_TP_M, AUDIO_K, "musicgen wq / wk / wv tp 2")
    del f
    B, L = TP_BATCH, TP_SEQ
    for heads, launches, note, who in ((VIS_TP_HEADS, l52, note52, "a vision rank's"),
                                       (AUDIO_TP_HEADS, l53, note53, "a musicgen rank's")):
        H, KV, dh = heads
        errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
        check_k3_k45(gen, B, L, H, KV, dh, 0, None, torch.bfloat16, errs, repeat=True)
        att = attention_inputs(gen, B, L, H, KV, dh)
        at = f"{who} heads ({B}, {L}, {H}/{KV}, {dh})"
        for kern, name, src, rep in (("K3", "flash_attention_fwd", K3_SOURCE, K3_REPLACES),
                                     ("K4", "flash_attention_dq", K45_SOURCE, K4_REPLACES),
                                     ("K5", "flash_attention_dkv", K45_SOURCE, K5_REPLACES)):
            rows.append(_kernel_row(f"{name} ({kern}, {at})", src, rep,
                                    launches.get(name, 0), errs[kern], *att[kern]))
            notes.append((note, ""))
        del att
        torch.cuda.empty_cache()
    H, KV, dh = TP_HEADS
    check_k3_k45(gen, B, L, H, KV, dh, 0, None, torch.float32, {"K3": 0.0, "K4": 0.0,
                                                                "K5": 0.0})
    print_rows(rows, notes, tag)
    torch.cuda.empty_cache()
    return rows


def run_xar_tp_phases(gen, smi, jobs=XAR_TP_JOBS, res=None):
    """Phases 52-55 (``jobs``: tools/tp_phases.py cuts their depth;
    ``res``: their jobs as phase 43's ranks ran them). Returns the kernel
    rows."""
    t0 = time.perf_counter()
    res = phase_xar_tensor_parallel(smi, jobs, res)
    rows = xar_kernel_rows(gen, res[0], res[1], smi)
    print(f"[tp] phases 52-55 wall {time.perf_counter() - t0:.1f} s")
    return rows


def start():
    """What every run does first: a card and the package next to this
    script, f32 products out of TF32, every kernel built (phase 1).
    Returns nvidia-smi's line and the seeded generator of the phases."""
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the repro_torch package is not next to {Path(__file__).name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device_and_build()
    return smi, torch.Generator(device="cuda").manual_seed(1234)


def run_moe_phases(gen, smi):
    """Phases 14-17: the batched K1 / K2 and granite's K3-K7 against their
    plain versions, granite-moe-3b-a800m served and trained, granite smoke
    card against CPU (residual and reversible), the MoE kernel rows.
    Returns (the kernels' errors, the rows)."""
    errs = phase_moe_kernels(gen)
    serve = phase_moe_serving(smi)
    train = phase_moe_training(smi)
    phase_card_vs_cpu(MOE_SMOKE, MOE_SMOKE_SPEC)
    phase_reversible_card_vs_cpu(MOE_SMOKE, MOE_SMOKE_SPEC)
    return errs, phase_moe_numbers(gen, serve, train, smi, errs)


def main() -> int:
    import torch

    t0 = time.perf_counter()
    last = [t0]

    def lap(what: str) -> None:
        """A ``[time]`` line: the phase's own seconds and the elapsed wall."""
        now = time.perf_counter()
        print(f"[time] {what}: {now - last[0]:.1f} s, done at {now - t0:.1f} s")
        last[0] = now

    smi, gen = start()
    lap("phase 1 (card, build)")
    err3 = phase_k3(gen)
    err6 = phase_k6(gen)
    counts, stats, peak, dense = phase_serving()
    kernels = phase_numbers(gen, counts, stats, smi, err3, err6, peak)
    dense.update(peak=peak, kv_mb=stats["cache/kv_capacity_mb"])
    torch.cuda.empty_cache()
    lap("K3, K6, serving and its numbers (phases 2-5)")
    errs78 = phase_k7_k8(gen)
    paged_counts, _, paged_tokens = phase_paged_serving(dense, smi)
    lap("K7 / K8 and paged fp serving (phases 6-7)")
    cut = cut_serving(dense)
    pool_res = phase_compressed_pools(cut, smi)
    lap("compressed pools (phase 7)")
    phase_prefix_and_spec(dense, paged_tokens, smi)
    paged_rows = phase_paged_numbers(gen, paged_counts, pool_res, smi, errs78)
    del dense
    torch.cuda.empty_cache()
    lap("prefix sharing, speculative verify and the paged numbers (phase 7)")
    phase_serving_front(cut, smi)
    phase_serve_step(cut, smi)
    lap("serving front and serve_step (phase 8)")
    errs_shard = phase_sharded_kernels(gen)
    shard_counts = phase_sharded_serving(cut, smi)
    shard_rows = sharded_rows(gen, shard_counts, errs_shard, smi)
    del cut
    torch.cuda.empty_cache()
    lap("sharded serving phases 40-41")
    errs = phase_training_kernels(gen)
    phase_card_vs_cpu()
    per_step, rec = phase_training(smi)
    phase_memory_modes(smi, rec)
    phase_reversible_card_vs_cpu()
    phase_supervised_restart(smi)
    lap("training phases 9-12")
    errs_moe, moe_rows = run_moe_phases(gen, smi)
    phase_moe_blocked(smi)
    lap("MoE phases 14-17 and 42")
    ssm_rows = run_ssm_phases(gen, smi)
    lap("ssm phases 18-21")
    rec_rows = run_rec_phases(gen, smi)
    lap("rec phases 22-25")
    vision_rows = run_vision_phases(gen, smi)
    lap("vision phases 26-29")
    audio_rows = run_audio_phases(gen, smi)
    lap("audio phases 30-34")
    mesh_rows = run_mesh_phases(gen, smi)
    lap("mesh phases 35-39")
    # phase 44's four ranks also run phase 49's data x model job, phase
    # 43's two ranks phases 52-54's jobs
    tp_rows, (ssm_dtp, *xar_res) = run_tp_phases(gen, smi, dtp_extra=(ssm_dtp_job(),),
                                                 tp_extra=XAR_TP_JOBS)
    lap("tensor-parallel phases 43-45 (and phases 49's data x model and 52-54's jobs)")
    # phases 47-48's two ranks also run phases 49-50's jobs
    split_rows, kind_res = run_split_and_expert_phases(gen, smi, extra=KIND_TP_JOBS)
    lap("row-parallel and expert-parallel phases 46-48 (and phases 49-50's jobs)")
    kind_rows = run_kind_tp_phases(gen, smi, dtp_res=ssm_dtp, res=kind_res)
    lap("ssm and rec / latt tensor-parallel phases 49-51")
    xar_rows = run_xar_tp_phases(gen, smi, res=xar_res)
    lap("xattn, audio and reversible tensor-parallel phases 52-55")
    # K3: serving and training shapes, internlm2's and granite's
    kernels[0]["max_abs_err"] = max(err3, errs["K3"], errs_moe["K3"])
    kernels += phase_training_numbers(gen, per_step, rec, smi, errs)
    kernels += paged_rows
    kernels += shard_rows
    kernels += moe_rows
    kernels += ssm_rows
    kernels += rec_rows
    kernels += vision_rows
    kernels += audio_rows
    kernels += mesh_rows
    kernels += tp_rows
    kernels += split_rows
    kernels += kind_rows
    kernels += xar_rows
    lap("training numbers")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
