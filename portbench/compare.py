"""The numbers that decide `correct`: each output of the program against
the plain reference's, row by row, then the worst row.

A row's reading (kind):
  rel       ||program - reference|| / ||reference|| (L2 over the row)
  polar     the same of the complex track a e^{j phi}, from (amplitude,
            phase) fields: phases weighed by their amplitudes, so a phase
            that a zero amplitude leaves free counts for nothing
  complex   the same of the complex track re + j im, from (re, im) fields
  exact     the number of entries that differ at all
  rel_gated, polar_gated
            rel, polar with the tracks (the last axis: harmonics) that the
            reference marks in its "gate_marginal" [K] left out of both
            sides: those whose denoiser gate lies within a rounding of its
            threshold (llsm_ref.gate_marginal), so that two float32
            evaluations may decide it either way
"""
from __future__ import annotations

import torch

GATE_FIELD = "gate_marginal"


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    wide = torch.complex128 if p.is_complex() else torch.float64
    p, r = p.to(wide), r.to(wide)
    den = torch.linalg.vector_norm(r)
    num = torch.linalg.vector_norm(p - r)
    return float(num / den) if float(den) > 0 else float(num)


def _pair(kind: str, names: tuple, side: dict) -> torch.Tensor:
    if kind == "polar":
        return torch.polar(side[names[0]].double(), side[names[1]].double())
    if kind == "complex":
        return torch.complex(side[names[0]].double(), side[names[1]].double())
    return side[names[0]]


def reading(kind: str, names: tuple, prog: dict, ref: dict) -> float:
    """One number of one row."""
    base, _, gated = kind.partition("_")
    if base not in ("rel", "polar", "complex", "exact") \
            or gated not in ("", "gated"):
        raise ValueError(f"unknown comparison {kind!r}")
    p, r = _pair(base, names, prog), _pair(base, names, ref)
    if base == "exact":
        return float((p != r).sum())
    if gated:
        keep = ~ref[GATE_FIELD].to(torch.bool)
        p, r = p[..., keep], r[..., keep]
    return _rel(p, r)


def numbers(compared: tuple, rows: list) -> dict:
    """compared: (name, kind, fields) tuples; rows: (program outputs,
    reference outputs) dict pairs -> {name: the worst row's reading}, NaN
    where no row was compared (or a reading is NaN)."""
    out = {}
    for name, kind, fields in compared:
        vals = [reading(kind, fields, p, r) for p, r in rows]
        out[name] = float("nan") if not vals or any(
            v != v for v in vals) else max(vals)
    return out
