"""Command-line demos of the PyTorch port (counterpart of
libllsm2_tpu.cli; the user-facing analog of the reference's test/demo
binaries), with the same commands and flags:

  python -m libllsm2_tpu_torch.cli roundtrip in.wav out.wav
  python -m libllsm2_tpu_torch.cli pitch-shift in.wav out.wav --ratio 2.0
  python -m libllsm2_tpu_torch.cli stretch in.wav out.wav --ratio 1.5
  python -m libllsm2_tpu_torch.cli formant-shift in.wav out.wav --ratio 1.2
  python -m libllsm2_tpu_torch.cli breathiness in.wav out.wav --gain-db 6
  python -m libllsm2_tpu_torch.cli vibrato in.wav out.wav --rate 5.5 --depth 0.35
  python -m libllsm2_tpu_torch.cli tremolo in.wav out.wav --rate 5.5 --depth-db 3
  python -m libllsm2_tpu_torch.cli creak in.wav out.wav --creak-depth 0.5
  python -m libllsm2_tpu_torch.cli morph a.wav b.wav out.wav --t 0.5
  python -m libllsm2_tpu_torch.cli concat a.wav b.wav out.wav --xf 8
  python -m libllsm2_tpu_torch.cli pbp in.wav out.wav [--rd 1.8]
  python -m libllsm2_tpu_torch.cli code in.wav out.npz [--bits 8|16] / decode in.npz out.wav
  python -m libllsm2_tpu_torch.cli track-f0 in.wav out.txt

All commands run F0 tracking internally (no external tracker needed) and
accept --fs-out for output-rate conversion.  They run on the card;
LLSM_PLATFORM=cpu runs them on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np


def _device() -> str:
    """The card, unless LLSM_PLATFORM names another torch device type
    (e.g. LLSM_PLATFORM=cpu)."""
    import os
    return os.environ.get("LLSM_PLATFORM") or "cuda"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _analyze_file(path: str, args):
    import dataclasses

    import torch

    from . import create_aoptions
    from .models import layer0
    from .ops import f0 as f0mod, resample
    from .utils import audio

    x, fs = audio.wavread(path)
    opt = create_aoptions(fs=fs)
    if getattr(args, "denoise", 0.0) > 0.0:
        opt = dataclasses.replace(opt, track_lowpass_hz=args.denoise)
    if opt.fs_input:
        # non-integral hop at the file's rate (e.g. 44.1 kHz @ 5 ms):
        # resample once here so F0 tracking and analysis share the
        # internal-rate signal (ciglet.h -> rresample)
        x = _host(resample.resample_to(torch.as_tensor(x, device=_device()),
                                       fs, opt.conf.fs))
        opt = dataclasses.replace(opt, fs_input=0.0)
    cfg = f0mod.F0Config(fs=opt.conf.fs, nhop=opt.conf.nhop)
    f0 = f0mod.track(cfg, np.asarray(x, np.float32), device=_device())
    chunk = layer0.analyze(opt, x, f0, device=_device())
    return x, fs, chunk


def _cmd_batch(args):
    """Corpus QA from the CLI: analyze+resynthesize every WAV in a
    directory through the bucketed batched runner (native loader, F0
    sidecars or the built-in tracker) and write a JSON report; with
    --audio-dir, also write the resynthesized WAVs."""
    import json
    import os
    import time

    from . import create_aoptions, create_soptions
    from .parallel import corpus
    from .utils import audio, dataio

    indir = args.input
    paths = sorted(os.path.join(indir, p) for p in os.listdir(indir)
                   if p.lower().endswith(".wav"))
    assert paths, f"no .wav files in {indir}"
    # one header scan: sample-rate probe (all files share one conf, like
    # the reference's per-conf processing) + processed-audio accounting
    # (utterances beyond the largest bucket are truncated by the runner,
    # so billing their full duration would overstate x_realtime)
    infos = {p: dataio.wav_info(p) for p in paths}
    fs = next((r for _, r in infos.values() if r), 0)
    assert fs, f"no parseable .wav headers in {indir}"
    opt = create_aoptions(fs=fs)
    assert not opt.fs_input, (
        f"batch mode loads raw PCM without resampling; {fs} Hz is not an "
        "integral-hop rate (use the per-file commands, which resample)")
    sopt = create_soptions(fs=opt.conf.fs)
    bucket_frames = (200, 400, 800, 1600)
    max_samp = bucket_frames[-1] * opt.conf.nhop
    want_audio = args.audio_dir is not None
    if want_audio:
        os.makedirs(args.audio_dir, exist_ok=True)

    t0 = time.perf_counter()
    rows = []
    total_sec = 0.0
    for batch in corpus.run_corpus_files(opt, sopt, paths,
                                         bucket_frames=bucket_frames,
                                         batch_size=args.batch_size,
                                         want_audio=want_audio,
                                         device=_device()):
        for j, p in enumerate(batch["paths"]):
            nsamp = min(infos[p][0], max_samp)
            if nsamp == 0:       # corrupt/unreadable: flag, do not let
                rows.append({"path": p, "failed": True})   # -inf poison
                continue                                   # the mean
            rows.append({"path": p,
                         "snr_db": round(float(batch["snr"][j]), 2)})
            total_sec += nsamp / opt.conf.fs
            if want_audio:
                nx = int(batch["nx"][j])
                y = batch["y"][j, :nx]
                outp = os.path.join(args.audio_dir,
                                    os.path.basename(p))
                audio.wavwrite(outp, y, sopt.fs)
    dt = time.perf_counter() - t0
    snrs = [r["snr_db"] for r in rows if "snr_db" in r]
    report = {
        "n_files": len(rows),
        "n_failed": sum(1 for r in rows if r.get("failed")),
        "audio_sec": round(total_sec, 2),
        "wall_sec": round(dt, 2),
        "x_realtime": round(total_sec / max(dt, 1e-9), 1),
        "mean_snr_db": round(float(np.mean(snrs)), 2) if snrs else None,
        "files": rows,
    }
    with open(args.output, "w") as f:
        json.dump(report, f, indent=1)
    print(f"batch: {len(rows)} files ({report['n_failed']} failed), "
          f"{report['x_realtime']}x realtime, "
          f"mean SNR {report['mean_snr_db']} dB -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="libllsm2_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    two_input = {"morph", "concat"}
    for name in ["roundtrip", "pitch-shift", "stretch", "formant-shift",
                 "breathiness", "vibrato", "tremolo", "creak", "morph",
                 "concat", "pbp", "code", "decode", "track-f0", "batch"]:
        p = sub.add_parser(name)
        p.add_argument("input")
        if name in two_input:
            p.add_argument("input2")
        p.add_argument("output")
        p.add_argument("--ratio", type=float, default=2.0)
        p.add_argument("--rd", type=float, default=None)
        p.add_argument("--gain-db", type=float, default=6.0)
        p.add_argument("--rd-delta", type=float, default=0.0)
        p.add_argument("--rate", type=float, default=5.5,
                       help="vibrato/tremolo modulation rate [Hz]")
        p.add_argument("--depth", type=float, default=0.35,
                       help="vibrato depth [semitones]")
        p.add_argument("--depth-db", type=float, default=3.0,
                       help="tremolo depth [dB]")
        p.add_argument("--t", type=float, default=0.5,
                       help="morph weight: 0 = first voice, 1 = second")
        p.add_argument("--xf", type=int, default=8,
                       help="concat crossfade length [frames]")
        p.add_argument("--creak-depth", type=float, default=0.5,
                       help="creak subharmonic depth (0..1)")
        p.add_argument("--subdiv", type=int, default=2,
                       help="creak period multiplier")
        p.add_argument("--fs-out", type=float, default=None)
        p.add_argument("--seed", type=int, default=0x5eed)
        p.add_argument("--denoise", type=float, default=0.0, metavar="HZ",
                       help="harmonic-track lowpass cutoff for breathy "
                            "recordings (try 30; smears fast dynamics)")
        p.add_argument("--bits", type=int, default=0, choices=(0, 8, 16),
                       help="code: write QUANTIZED coder vectors instead "
                            "of the full chunk (8 = 4x smaller, "
                            "parameter-faithful; 16 = render-transparent)")
        p.add_argument("--batch-size", type=int, default=16,
                       help="batch: utterances per device dispatch")
        p.add_argument("--audio-dir", default=None,
                       help="batch: also write resynthesized WAVs here")
    args = ap.parse_args(argv)

    if args.cmd == "batch":
        _cmd_batch(args)
        return

    import torch

    from . import create_soptions
    from .models import edits, layer0, layer1, pbp
    from .utils import audio, serialize

    if args.cmd == "track-f0":
        from .ops import f0 as f0mod
        x, fs = audio.wavread(args.input)
        cfg = f0mod.F0Config(fs=fs)
        f0 = _host(f0mod.track(cfg, np.asarray(x, np.float32),
                               device=_device()))
        np.savetxt(args.output, f0, fmt="%.3f")
        print(f"wrote {len(f0)} frames -> {args.output}")
        return

    if args.cmd == "decode":
        with np.load(args.input) as z:
            coded = "__coded__" in z.files
        if coded:
            from .models import coder as coder_mod
            cc, v = serialize.coded_load(args.input)
            chunk = coder_mod.decode(cc, v, device=_device())
        else:
            chunk = serialize.chunk_load(args.input, device=_device())
        sopt = create_soptions(fs=args.fs_out or chunk.conf.fs,
                               noise_seed=args.seed)
        out = layer0.synthesize(sopt, chunk)
        audio.wavwrite(args.output, _host(out.y), out.fs)
        print(f"decoded -> {args.output}")
        return

    x, fs, chunk = _analyze_file(args.input, args)
    sopt = create_soptions(fs=args.fs_out or fs, noise_seed=args.seed)

    if args.cmd == "roundtrip":
        out = layer0.synthesize(sopt, chunk)
    elif args.cmd == "pitch-shift":
        l1 = layer1.chunk_to_layer1(chunk)
        out = layer0.synthesize(sopt, edits.pitch_shift(l1, args.ratio))
    elif args.cmd == "stretch":
        out = layer0.synthesize(sopt, edits.time_stretch(chunk, args.ratio))
    elif args.cmd == "formant-shift":
        l1 = layer1.chunk_to_layer1(chunk)
        out = layer0.synthesize(sopt, edits.formant_shift(l1, args.ratio))
    elif args.cmd == "breathiness":
        c = chunk
        if args.rd_delta != 0.0:
            c = layer1.chunk_to_layer1(c)
        out = layer0.synthesize(
            sopt, edits.breathiness(c, args.gain_db, args.rd_delta))
    elif args.cmd == "vibrato":
        l1 = layer1.chunk_to_layer1(chunk)
        out = layer0.synthesize(
            sopt, edits.vibrato(l1, args.rate, args.depth))
    elif args.cmd == "tremolo":
        out = layer0.synthesize(
            sopt, edits.tremolo(chunk, args.rate, args.depth_db))
    elif args.cmd == "creak":
        l1 = layer1.chunk_to_layer1(chunk)
        out = layer0.synthesize(
            sopt, edits.creak(l1, args.creak_depth, args.subdiv))
    elif args.cmd == "morph":
        _, _, chunk2 = _analyze_file(args.input2, args)
        la = layer1.chunk_to_layer1(chunk)
        lb = layer1.chunk_to_layer1(chunk2)
        out = layer0.synthesize(sopt, edits.morph(la, lb, args.t))
    elif args.cmd == "concat":
        _, _, chunk2 = _analyze_file(args.input2, args)
        out = layer0.synthesize(sopt, edits.concat(chunk, chunk2, args.xf))
    elif args.cmd == "pbp":
        l1 = layer1.chunk_to_layer1(chunk)
        if args.rd is not None:
            l1 = l1.replace(rd=torch.full_like(l1.rd, args.rd))
        out = pbp.pbp_synthesize(sopt, l1)
    elif args.cmd == "code":
        l1 = layer1.chunk_to_layer1(chunk)
        if args.bits:
            from .models import coder as coder_mod
            cc = coder_mod.CoderConfig(conf=l1.conf)
            v = _host(coder_mod.encode(cc, l1))
            serialize.coded_save(args.output, cc, v, bits=args.bits)
            print(f"encoded {l1.nfrm} frames at {args.bits} bits/slot "
                  f"-> {args.output}")
        else:
            serialize.chunk_save(args.output, l1)
            print(f"encoded {l1.nfrm} frames -> {args.output}")
        return
    else:
        ap.error(f"unknown command {args.cmd}")

    y = _host(out.y)
    audio.wavwrite(args.output, y, out.fs)
    print(f"{args.cmd}: {args.input} -> {args.output} "
          f"({len(y) / out.fs:.2f}s @ {out.fs:.0f} Hz)")


if __name__ == "__main__":
    main()
