"""The port's single-device edges on the CPU: its CLI
(libllsm2_tpu_torch.cli, LLSM_PLATFORM=cpu) with tests/test_cli.py's six
cases and the other nine commands, the profiler hooks
(utils/profiling.py) and the plotting helpers (utils/plotting.py)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from libllsm2_tpu_torch import cli, create_aoptions, create_soptions
from libllsm2_tpu_torch.models import layer0
from libllsm2_tpu_torch.utils import audio, profiling, testsig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("tcli")
    x, _ = testsig.make_test_utterance(duration=0.4, seed=3)
    p = str(d / "in.wav")
    audio.wavwrite(p, x.astype(np.float32), 16000)
    prev = os.environ.get("LLSM_PLATFORM")
    os.environ["LLSM_PLATFORM"] = "cpu"
    yield p, str(d)
    if prev is None:
        del os.environ["LLSM_PLATFORM"]
    else:
        os.environ["LLSM_PLATFORM"] = prev


def _dur(path):
    y, fs = audio.wavread(path)
    return len(y) / fs, y


def test_cli_roundtrip(wav):
    p, d = wav
    out = os.path.join(d, "rt.wav")
    cli.main(["roundtrip", p, out])
    dur, y = _dur(out)
    assert abs(dur - 0.4) < 0.02 and float(np.std(y)) > 1e-3


def test_cli_roundtrip_44k_resamples_on_the_device_and_matches_jax(wav,
                                                                   monkeypatch):
    """A 44.1 kHz file (a hop of 220.5 samples: the CLI resamples it to
    the analysis rate first) through both CLIs: the port resamples tensors
    on the device LLSM_PLATFORM names, writes 0.4 s at 44.1 kHz, and
    its WAV is within two 16-bit steps of the JAX CLI's (measured: one)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from libllsm2_tpu import cli as jcli

    from libllsm2_tpu_torch.ops import resample
    _, d = wav
    x, _ = testsig.make_test_utterance(duration=0.4, fs=44100.0, seed=3)
    p = os.path.join(d, "in44.wav")
    audio.wavwrite(p, x.astype(np.float32), 44100)
    seen, resample_to = [], resample.resample_to

    def spy(t, *a, **k):
        seen.append(t.device.type)
        return resample_to(t, *a, **k)
    monkeypatch.setattr(resample, "resample_to", spy)
    out, outj = os.path.join(d, "rt44.wav"), os.path.join(d, "rt44j.wav")
    cli.main(["roundtrip", p, out])
    jcli.main(["roundtrip", p, outj])
    assert seen and set(seen) == {cli._device()}, seen
    dur, y = _dur(out)
    yj, fs = audio.wavread(outj)
    assert fs == 44100 and abs(dur - 0.4) < 0.02 and len(y) == len(yj)
    assert np.abs(y - yj).max() <= 2 / 32768
    lo, hi = int(0.1 * len(y)), int(0.9 * len(y))
    snr = 10 * np.log10(np.sum(x[lo:hi] ** 2)
                        / np.sum((x[lo:hi] - y[lo:hi]) ** 2))
    assert snr > 20.0, snr


def test_cli_pitch_shift_ratio(wav):
    p, d = wav
    out = os.path.join(d, "ps.wav")
    cli.main(["pitch-shift", p, out, "--ratio", "1.5"])
    _, y = _dur(out)
    assert float(np.std(y)) > 1e-3


def test_cli_track_f0(wav):
    p, d = wav
    out = os.path.join(d, "f0.txt")
    cli.main(["track-f0", p, out])
    f0 = np.loadtxt(out)
    v = f0[f0 > 0]
    assert len(v) > 0.8 * len(f0)
    assert 100 < np.median(v) < 200


def test_cli_code_decode(wav):
    p, d = wav
    npz = os.path.join(d, "c.npz")
    out = os.path.join(d, "dec.wav")
    cli.main(["code", p, npz])
    assert os.path.exists(npz)
    cli.main(["decode", npz, out])
    _, y = _dur(out)
    assert float(np.std(y)) > 1e-3


def test_cli_code_decode_quantized(wav):
    p, d = wav
    npz = os.path.join(d, "cq.npz")
    out = os.path.join(d, "decq.wav")
    cli.main(["code", p, npz, "--bits", "8"])
    with np.load(npz) as z:
        assert "__coded__" in z.files and z["codes"].dtype == np.uint8
    cli.main(["decode", npz, out])
    _, y = _dur(out)
    assert float(np.std(y)) > 1e-3


def test_cli_batch_report(wav):
    p, d = wav
    bdir = os.path.join(d, "batchin")
    os.makedirs(bdir, exist_ok=True)
    shutil.copy(p, os.path.join(bdir, "a.wav"))
    rep = os.path.join(d, "report.json")
    cli.main(["batch", bdir, rep, "--batch-size", "2"])
    with open(rep) as f:
        r = json.load(f)
    assert r["n_files"] == 1 and r["n_failed"] == 0
    assert r["mean_snr_db"] > 15.0


# the other nine commands: each writes a finite WAV of the expected length
# (stretch x1.5 of 0.4 s; concat: two copies less an 8-frame crossfade)
OTHERS = [("stretch", ["--ratio", "1.5"], 0.6), ("formant-shift", ["--ratio", "1.2"], 0.4),
          ("breathiness", ["--gain-db", "6"], 0.4),
          ("vibrato", ["--rate", "5.5", "--depth", "0.35"], 0.4),
          ("tremolo", ["--depth-db", "3"], 0.4),
          ("creak", ["--creak-depth", "0.5"], 0.4),
          ("morph", ["--t", "0.5"], 0.4), ("concat", ["--xf", "8"], 0.76),
          ("pbp", ["--rd", "1.8"], 0.4)]


@pytest.mark.parametrize("cmd,flags,seconds", OTHERS,
                         ids=[o[0] for o in OTHERS])
def test_cli_other_commands(wav, cmd, flags, seconds):
    p, d = wav
    out = os.path.join(d, f"{cmd}.wav")
    two = [p] if cmd in ("morph", "concat") else []
    cli.main([cmd, p, *two, out, *flags])
    dur, y = _dur(out)
    assert abs(dur - seconds) < 0.02, dur
    assert np.isfinite(y).all() and float(np.std(y)) > 1e-3


def test_device_trace_names_the_five_scopes(tmp_path):
    """device_trace on the CPU writes a Chrome trace holding layer0's five
    stage scopes (the JAX package's llsm.* named scopes) and, with the
    kernels on (their CPU twins), the spans inside the analysis: the
    refine, the cycle tracks, the residual's and the noise stage's
    sub-stages."""
    x, f0 = testsig.make_test_utterance(duration=0.3, seed=1)
    opt = create_aoptions(use_pallas=True)
    sopt = create_soptions(use_pallas=True)
    with profiling.device_trace(str(tmp_path)) as prof:
        layer0.synthesize(sopt, layer0.analyze(opt, x, f0, device="cpu"))
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for scope in ("llsm.analyze.harmonic", "llsm.analyze.residual",
                  "llsm.analyze.noise", "llsm.synth.harmonic",
                  "llsm.synth.noise", "llsm.analyze.refine", "llsm.cycles",
                  *(f"llsm.analyze.residual.{s}" for s in (
                      "deconv", "stats", "floor", "apply", "gate",
                      "gate.dft", "render")),
                  *(f"llsm.analyze.noise.{s}" for s in (
                      "envelopes", "project", "psd"))):
        assert scope in names, scope
    assert prof.key_averages()


def test_plot_chunk_writes_png(tmp_path):
    from libllsm2_tpu_torch.utils import plotting
    x, f0 = testsig.make_test_utterance(duration=0.3, seed=1)
    chunk = layer0.analyze(create_aoptions(), x, f0, device="cpu")
    plotting.plot_chunk(chunk, str(tmp_path / "c.png"))
    plotting.plot_spectra(str(tmp_path / "s.png"), 16000.0,
                          x=x, y=torch.tensor(x))
    assert (tmp_path / "c.png").stat().st_size > 0
    assert (tmp_path / "s.png").stat().st_size > 0
