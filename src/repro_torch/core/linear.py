"""Exact projections (``repro/core/linear.py:_exact_linear``).

Weights keep the JAX layout ``w (n_in, n_out)`` applied as ``x @ w``;
the compressed (PAMM) projections arrive with the training slice.
"""
from __future__ import annotations


def _exact_linear(x2d, w, bias):
    z2d = x2d @ w.to(x2d.dtype)
    if bias is not None:
        z2d = z2d + bias.to(z2d.dtype)
    return z2d
