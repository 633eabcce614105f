"""Where the PyTorch port's SNR on a CUDA card leaves its SNR on the CPU: the
16 kHz bench rows 0, 1 (noisy) and 64 (clean) at 8 s through
batched_pipeline with the library default (chip_smoke.py phase 5), on the
card and on the CPU, then

  diff    each analysis stage run on the card on the CPU run's own inputs
          to it: the largest difference of its outputs from the CPU's,
          relative to their peak (an (ampl, phse) pair as ampl e^{j phse};
          the cycle track mod 1, in cycles);
  swap    the card run again with one stage at a time computed on the CPU
          (its inputs moved there, its outputs moved back): the stage whose
          swap brings the card's SNR to the CPU's is where they part;
  batch   the same three rows at their places (0, 1, 64) in the whole
          bench batch of `batch` rows on the card, every stage call's
          inputs and outputs for those rows against the three-row run's, in
          call order: the first call whose inputs are equal and whose
          outputs differ is where a row's result starts to depend on the
          batch.

Imports neither jax nor libllsm2_tpu; needs a CUDA card:

    python scripts/port_card_vs_cpu.py [duration=8.0] [device=cuda] \
        [batch=128]

(device=cpu runs the same steps with the CPU in the card's place, which
checks the script and must show no difference.)
"""
import dataclasses
import sys
import time

import numpy as np
import torch

from libllsm2_tpu_torch import create_aoptions, create_soptions
from libllsm2_tpu_torch.models import layer0
from libllsm2_tpu_torch.ops import harmonics, kernels
from libllsm2_tpu_torch.parallel import corpus
from libllsm2_tpu_torch.utils import testsig

ROWS = {0: 0.05, 1: 0.05, 64: 0.0}      # bench row -> noise level
N_NOISY = 64                            # bench rows [0, 64) are noisy
STAGES = [(harmonics, "refine_f0"), (harmonics, "sample_cycles"),
          (harmonics, "harmonic_analysis"), (layer0, "_deconv_correction"),
          (kernels, "denoise_stats"), (layer0, "_denoise_floor_stats"),
          (kernels, "denoise_apply"), (layer0, "_spectral_gate"),
          (layer0, "_track_denoise"), (kernels, "osc_bank")]


def _move(v, dev):
    if torch.is_tensor(v):
        return v.to(dev)
    if isinstance(v, (tuple, list)):
        return type(v)(_move(u, dev) for u in v)
    if isinstance(v, dict):
        return {k: _move(u, dev) for k, u in v.items()}
    return v


def _flat(v):
    if torch.is_tensor(v):
        yield v
    elif isinstance(v, (tuple, list)):
        for u in v:
            yield from _flat(u)
    elif isinstance(v, dict):
        for u in v.values():
            yield from _flat(u)


def _cut(v, rows, B):
    """v's tensors cut to the batch rows `rows`, on the CPU: a tensor of
    m B leading rows (m = 1, or 4 for the envelope pass's bands) keeps rows
    r m .. r m + m - 1 of each r in `rows`; other tensors stay whole."""
    if torch.is_tensor(v):
        m = v.shape[0] // B if v.dim() and v.shape[0] % B == 0 else 0
        if m in (1, 4):
            idx = torch.tensor([r * m + j for r in rows for j in range(m)],
                               device=v.device)
            v = v.index_select(0, idx)
        return v.cpu()
    if isinstance(v, (tuple, list)):
        return [_cut(u, rows, B) for u in v]
    if isinstance(v, dict):
        return {k: _cut(u, rows, B) for k, u in v.items()}
    return v


def _compared(name, out):
    """A stage's outputs as compared: an (ampl, phse) pair as the complex
    ampl e^{j phse} (phases wrap where the amplitude vanishes), a (re, im)
    pair as re + j im, booleans as 0/1, all on the CPU."""
    out = [out] if torch.is_tensor(out) else list(out)
    out = [t.cpu() for t in out]
    if name in ("harmonic_analysis", "_track_denoise"):
        out[:2] = [torch.polar(out[0], out[1])]
    elif name == "_deconv_correction":
        out[:2] = [torch.complex(out[0], out[1])]
    return [t.to(torch.float32) if t.dtype == torch.bool else t for t in out]


def _peak_rel(name, a, b):
    """max |a - b| / max |b| over a stage's compared outputs; the cycle
    track's difference is taken mod 1 and is absolute (cycles)."""
    if name == "sample_cycles":
        d = (a.cpu().double() - b.cpu().double())
        return float((d - torch.round(d)).abs().max())
    ta, tb = _compared(name, a), _compared(name, b)
    num = max(float((x - y).abs().max()) for x, y in zip(ta, tb))
    den = max(float(y.abs().max()) for y in tb)
    return num / max(den, 1e-30)


def main():
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    duration = float(kw.get("duration", 8.0))
    n_batch = int(kw.get("batch", 128))
    card = torch.device(kw.get("device", "cuda"))
    if card.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)
    cpu = torch.device("cpu")
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    rows = testsig.make_test_utterances(list(ROWS.items()),
                                        duration=duration)
    data = [np.stack([r[j] for r in rows]).astype(np.float32)
            for j in range(3)]

    def run(dev, data=data):
        x, f0, x_ref = (torch.tensor(a, device=dev) for a in data)
        nxv = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                         device=dev)
        _, snr, _ = corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
        return [round(float(v), 6) for v in snr.cpu()]

    t0 = time.perf_counter()
    snr_card, snr_cpu = run(card), run(cpu)
    print(f"rows {list(ROWS)}: SNR card {snr_card} dB, CPU {snr_cpu} dB "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # diff: every stage on the card on the CPU run's inputs to it
    orig = {(mod, name): getattr(mod, name) for mod, name in STAGES}
    calls = {}
    for (mod, name), fn in orig.items():

        def rec(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            calls.setdefault(_name, (a, k, out))
            return out
        setattr(mod, name, rec)
    try:
        run(cpu)
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)
    for (mod, name), fn in orig.items():
        if name not in calls:
            print(f"diff {name}: not called", flush=True)
            continue
        a, k, out = calls[name]
        got = fn(*_move(a, card), **_move(k, card))
        print(f"diff {name}: card on the CPU's inputs, max |card - CPU| / "
              f"max |CPU| = {_peak_rel(name, got, out):.3e}", flush=True)
    del calls

    # swap: the card run with one stage on the CPU
    for (mod, name), fn in orig.items():

        def on_cpu(*a, _fn=fn, **k):
            return _move(_fn(*_move(a, cpu), **_move(k, cpu)), card)
        setattr(mod, name, on_cpu)
        try:
            snr = run(card)
        finally:
            setattr(mod, name, fn)
        print(f"swap {name} to the CPU: SNR {snr} dB (card {snr_card}, "
              f"CPU {snr_cpu})", flush=True)
    if n_batch:
        batch_dependence(run, card, orig, duration, n_batch)
    return 0


def batch_dependence(run, card, orig, duration, n_batch):
    """The batch part (see the module's docstring)."""
    bench = testsig.make_test_utterances(
        [(i, 0.05 if i < N_NOISY else 0.0) for i in range(n_batch)],
        duration=duration)
    big = [np.stack([r[j] for r in bench]).astype(np.float32)
           for j in range(3)]
    del bench

    def record(data, rows):
        """Every stage call of run(card, data), in the order the calls
        end: (name, (args, kw) and outputs cut to `rows`)."""
        log, B = [], data[0].shape[0]
        for (mod, name), fn in orig.items():

            def rec(*a, _fn=fn, _name=name, **k):
                out = _fn(*a, **k)
                log.append((_name, _cut((a, k), rows, B), _cut(out, rows, B)))
                return out
            setattr(mod, name, rec)
        try:
            snr = run(card, data)
        finally:
            for (mod, name), fn in orig.items():
                setattr(mod, name, fn)
        return log, [snr[r] for r in rows]

    small, snr_small = record([a[list(ROWS)] for a in big], [0, 1, 2])
    whole, snr_whole = record(big, list(ROWS))
    print(f"batch: rows {list(ROWS)} alone SNR {snr_small} dB, in the "
          f"{n_batch}-row batch {snr_whole} dB", flush=True)
    first = None
    for i, ((name, ins, out), (name_w, ins_w, out_w)) in enumerate(
            zip(small, whole)):
        if name != name_w:
            print(f"batch: call {i} is {name} alone, {name_w} in the batch: "
                  "the call sequences part", flush=True)
            break
        ta, tb = list(_flat(ins_w)), list(_flat(ins))
        if [t.shape for t in ta] != [t.shape for t in tb]:
            same = "not comparable"
        else:
            same = ("equal" if all(torch.equal(a, b) for a, b in zip(ta, tb))
                    else "differ")
        rel = _peak_rel(name, out_w, out)
        print(f"batch: call {i} {name}: inputs {same}, outputs max |batch - "
              f"alone| / max |alone| = {rel:.3e}", flush=True)
        if first is None and same == "equal" and rel > 0:
            first = f"call {i} {name}"
    print(f"batch: the first call with equal inputs and different outputs: "
          f"{first}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
