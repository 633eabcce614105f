"""What the port's comparison scripts share: loading a checkout's
libllsm2_tpu_torch under an alias of its own (so two checkouts run in one
process), timing a step of calls by CUDA events, and alternated rounds of
options with their bits held to a reference.  Imported by
scripts/port_*.py (the scripts' directory is on sys.path when they run);
imports no jax.
"""
import importlib.util
import statistics
import sys
from pathlib import Path

import torch

CALLS = 10      # calls a timed step


def load(root: Path, alias: str):
    """The libllsm2_tpu_torch package under root, imported as `alias`."""
    pkg = root / "libllsm2_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def step_ms(fn, calls: int = CALLS):
    """One step of `calls` calls of fn (CUDA events) -> ms a call."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls


def same_bits(label: str, opts: dict, ref, bad: list) -> None:
    """Each option's outputs (a tensor or a tuple of them) against ref,
    bit for bit; a line each option, (label, option) appended to bad
    where they differ."""
    as_tuple = lambda v: v if isinstance(v, tuple) else (v,)
    for key, fn in opts.items():
        ok = all(torch.equal(a, b) for a, b in zip(as_tuple(fn()),
                                                   as_tuple(ref)))
        print(f"{label} {key}: the reference's bits {ok}", flush=True)
        if not ok:
            bad.append((label, key))


def rounds(label: str, opts: dict, pairs: int, bound=None,
           each_round: bool = False) -> dict:
    """One untimed step of each option, then `pairs` rounds of one step
    each, the options' order rotated a place each round and reversed
    every other cycle.  Prints each option's median and quartiles a call
    (with its ratio to bound = (ms, what bounds it), where given) and how
    many rounds the first option beat each other one -> {option: [ms a
    call, a round each]}."""
    for fn in opts.values():
        step_ms(fn)
    names = list(opts)
    times = {key: [] for key in names}
    for p in range(pairs):
        k = p % len(names)
        order = names[k:] + names[:k]
        if p // len(names) % 2:
            order = order[::-1]
        got = {key: step_ms(opts[key]) for key in order}
        for key in names:
            times[key].append(got[key])
        if each_round:
            print(f"{label} round {p} ({', '.join(order)}): " + ", ".join(
                f"{key} {got[key]:.4f}" for key in names) + " ms a call",
                flush=True)
    for key, ts in times.items():
        q = statistics.quantiles(ts, n=4)
        med = statistics.median(ts)
        tail = ("" if bound is None else f", {med / bound[0]:.2f}x its "
                f"bound {bound[0]:.4f} ms ({bound[1]})")
        print(f"{label} {key}: median {med:.4f} ms a call (quartiles "
              f"{q[0]:.4f}-{q[2]:.4f}){tail}", flush=True)
    for key in names[1:]:
        wins = sum(a < b for a, b in zip(times[names[0]], times[key]))
        print(f"{label}: {names[0]} faster than {key} in {wins} of {pairs} "
              f"rounds", flush=True)
    return times
