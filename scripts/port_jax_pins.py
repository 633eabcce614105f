"""The JAX package's own SNRs on the configurations that chip_smoke.py
drives through the PyTorch port (its phases 4, 5 and 7 to 10), on the CPU
with the Pallas kernels in interpret mode:

  16 kHz    batched_pipeline, create_aoptions(f0_floor=70, use_pallas=True)
            with create_soptions(use_pallas=True), on bench rows 0, 1
            (noisy) and 64 (clean), and with track_denoise=False on rows 0
            and 1;
  odd hop   batched_pipeline, create_aoptions(fs=11000, f0_floor=70,
            use_pallas=True) with create_soptions(fs=11000, use_pallas=True),
            on the bench seeds of noisy rows 0 and 1 and clean row 64
            (noise level 0.05 / 0), made at fs = 11000;
  11025 Hz  the public analyze -> synthesize at fs = 11025 (input and
            output resampled) on one noisy (seed 0) and one clean (seed 64)
            1 s row made at 11025 Hz: the SNR of y_sin against the clean
            harmonic part, OLA edges excluded;
  layer 1   create_aoptions(f0_floor=70, use_pallas=True) analysis of the
            bench rows 0, 1 (noisy) and 64 (clean) at 16 kHz, then
            chunk_to_layer1 -> chunk_to_layer0 -> synthesize: the SNR of
            y_sin against the clean harmonic part, OLA edges excluded;
  PbP       the same analysis of LF rows 0 and 1 (synth_lf_speech, Rd 0.4
            and 1.0, seeds 0 and 1, make_f0_track's default contour), then
            chunk_to_layer1 -> pbp_synthesize: the SNR of PbP y_sin against
            the layer-1 sinusoidal y_sin (synthesize(chunk_to_layer0(l1)));
  corpus    run_corpus_files (chip_smoke.py phase 11) on the first 16 files
            of phase 11's corpus (libllsm2_tpu_torch.utils.testsig
            .write_test_corpus, cut from the 8 s bench rows), with the
            16 kHz options above, buckets (200, 400, 800, 1600) and
            batch_size 8: each file's SNR, and for a file without an F0
            sidecar the voicing of the JAX tracker's track (ops.f0.track on
            the file's int16 row padded to its bucket, as run_corpus_files
            tracks it) as run lengths, unvoiced first;
  edits     BASELINE config 4 on LF rows 0 and 1 (as PbP): chunk_to_layer1,
            pitch_shift(2.0), time_stretch(1.5), synthesize: the edited
            chunk's frame count, its median voiced F0 and the rms of y_sin;
  coder     the codec (chip_smoke.py phase 13) on LF rows 0 and 1 (as PbP):
            chunk_to_layer1, encode with CoderConfig() (64 VT and 32 PSD
            dims), a quantizer fitted on the two rows (8 bits, Rd by DPCM,
            the F0 slot's voicing re-sync), its coded_save archive written
            to CODER_PINS (codes, ranges and the 16-bit F0 side array; the
            card compares its own codes with them), the y_sin rms of
            synthesize(decode(vectors)) and the mel-cepstral distortion of
            the 8-bit and 16-bit archives' decodes against it;
  nasal     the section-model Rd fit (chip_smoke.py phase 14) on nasal rows
            0 and 1 (synth_nasal_utterance, zero (900, 60) Hz, f0_base 120
            and 182 Hz, seed = row): the median voiced rd of
            chunk_to_layer1 with the sections ((250, 70, -1), (900, 60,
            +1)) and without;
  stream    runtime.rtanalyze.RTAnalyzer (chip_smoke.py phase 15a: blocks of
            64 hops with 48 of halo, fed 997 samples and 13 F0 frames at a
            time) with the 16 kHz options above on bench rows 0 and 1: the
            SNR of the streamed frames' ampl against the offline analysis's
            (denoiser on), and against the offline analysis with the
            denoiser off; then PbP streaming (chip_smoke.py phase 15c:
            stream_chunk(block=16, synth_mode="pbp")) of LF rows 0 and 1
            (as PbP): the SNR (utils.metrics.snr_db) of its output against
            pbp_synthesize's y_sin, whole and second by second;
  learned   chip_smoke.py phase 17d-e: the JAX package's AE, VQ codec and
            acoustic model at default widths (118-dim coder vectors; the
            acoustic model over ttsdata's 8 phones), initialized from
            PRNGKey(0) and snapped to 8-bit codes times a scale a leaf
            (which both packages then start from; the file stays under 1
            MB), a seeded input batch, each model's forward on it, 5 AdamW
            steps' losses (default compute dtype) and the VQ's tokens,
            written to LEARNED_PINS; then abs_refine on
            tests/test_abs.py's weakened analysis (100 steps, lr 0.1): the
            harmonic SNR before and after;
  fp64      chip_smoke.py phase 18a: tests/test_fp64.py's round trip in the
            JAX package under LLSM_FP64=1 (a subprocess): the SNR of
            y_sin over the middle 80%;
  dspkit    chip_smoke.py phase 16: batched_pipeline with the library
            default create_aoptions(f0_floor=70) and create_soptions()
            (use_pallas=False: the jnp branches) on bench rows 0, 1 (noisy)
            and 64 (clean); then create_aoptions(f0_floor=70,
            use_pallas=True) with hm_method="pp", hm_passes=2,
            hm_correction="none" and frame_chunk=64 in turn (the Pallas
            kernels in interpret mode) on rows 0 and 1;
  mesh      chip_smoke.py phase 19a: parallel.seqparallel's frame-sharded
            analysis and synthesis over make_mesh(4, frame_parallel=4) (4
            virtual CPU devices) with the 16 kHz options above, on two
            64 s utterances (make_test_utterance, seed 0 with noise 0.05
            and seed 64 clean): the SNR of y_sin against the clean harmonic
            part (snr_db below), and the same through the one-process
            analyze -> synthesize;
  wide      chip_smoke.py phase 20: batched_pipeline with the 16 kHz options
            above at creaky voice's conf (maxnhar=160, fnyq=6000: the
            denoiser at K = 160) on bench rows 0, 1 (noisy) and 64 (clean);
            then create_aoptions(fs=48000, thop=0.01, fnyq=12000,
            chanfreq=(3000, 6000, 9000), nspec=513, f0_floor=70,
            use_pallas=True) with create_soptions(fs=48000, use_pallas=True)
            (noise hop 480) on the same rows resampled to 48 kHz by
            ops.resample.resample_to, with every second F0 frame;
  h20       chip_smoke.py phase 20g: part wide's 48 kHz options with a
            20 ms hop (thop=0.02: hop 960, where the cycle track runs
            its long-hop kernel) on the same resampled rows, with every
            fourth F0 frame;
  h50       chip_smoke.py phase 20h: the same with a 50 ms hop (thop=0.05:
            hop 2400, where the projection runs 8-frame tiles and the cycle
            track its hop kernels), with every tenth F0 frame;
  fullband  chip_smoke.py phase 20e: batched_pipeline at full band, the
            16 kHz options above with f0_floor=40 and maxnhar = fs / 2 /
            f0_floor: create_aoptions(fs=48000, f0_floor=40, maxnhar=600)
            (fnyq 24000, the 5 ms hop; deconv_full at K = 600, D = 11) on
            the bench rows resampled to 48 kHz as in part wide, with every
            F0 frame; then create_aoptions(thop=0.002, f0_floor=40,
            maxnhar=200, fnyq=8000) (K = 200, D = 26) on the same rows
            made at a 2 ms hop (make_test_utterance(thop=0.002)); then
            rows 0, 1 and 64 again with each sample of x times 1 + 2^-23
            u, u uniform in [-1, 1) from seed 0 (within a float32 ulp:
            how far rounding alone moves each row's SNR);
  proj64    chip_smoke.py phase 20e's pins: part fullband's rows through
            the JAX package in float32 with its windowed harmonic
            projection (harmonic_project_win_pallas) computed in float64
            instead (numpy through jax.pure_callback, each harmonic's
            phase taken directly, as the card's kernel takes it);
  cyc64     the same with the cycle track (harmonics.sample_cycles) in
            float64 too: how far the cycle track's float32 rounding moves
            the rows (no pin reads it);
  fullband64  rows 0, 1 and 64 of part fullband through the JAX package
            under LLSM_FP64=1 (a subprocess; its plain branches,
            use_pallas=False, in float64; no pin reads it);
  fullbandmean  chip_smoke.py phase 20e's means: the same on all 128 bench
            rows (chunks of 16; ~20 min on the CPU), the mean SNR of the
            64 noisy and of the 64 clean rows.

    JAX_PLATFORMS=cpu python scripts/port_jax_pins.py [duration=8.0] \
        [only=l0,11k,l1,pbp,corpus,edits,coder,nasal,stream,dspkit,
              learned,fp64,mesh,wide,h20,h50,fullband,proj64,cyc64,
              fullband64,fullbandmean]
        [mesh_seconds=64]

CPU time of the parts added last, on an 8-core x86 host: corpus 49.3 s,
edits 42.1 s, coder 32.2 s, nasal 4.8 s (run after coder in one process);
learned ~25 s, fp64 ~15 s; mesh 127 s at 64 s.
"""
import dataclasses
import os
import sys
import time

# part mesh shards over 4 virtual CPU devices (set before jax loads)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from libllsm2_tpu import create_aoptions, create_soptions  # noqa: E402
from libllsm2_tpu.models import layer0, layer1, pbp  # noqa: E402
from libllsm2_tpu.parallel import corpus  # noqa: E402
from libllsm2_tpu.utils import testsig  # noqa: E402

ROWS = {0: 0.05, 1: 0.05, 64: 0.0}      # bench row -> noise level
LF_RD = (0.4, 1.0, 1.8, 2.7)            # chip_smoke.py phase 10: Rd of row i % 4
NASAL_F0 = (120.0, 182.0, 200.0)        # chip_smoke.py phase 14: f0_base of row i % 3
NASAL_SECTIONS = ((250.0, 70.0, -1.0), (900.0, 60.0, 1.0))
STREAM_BLOCK, STREAM_HALO = 64, 48        # chip_smoke.py phase 15a
# the JAX coder's 8-bit archive of LF rows 0 and 1 (part coder)
CODER_PINS = "scripts/port_jax_pins_coder.npz"
# the JAX learned models' weights, inputs and outputs (part learned)
LEARNED_PINS = "scripts/port_jax_pins_learned.npz"
LEARNED_STEPS = 5


def snr_db(ref, y, fs, f0_floor):
    """chip_smoke.py's phase-8 SNR: y against ref over the common length,
    minus an OLA margin of min(2 fs / f0_floor, n / 4) at both ends."""
    n = min(len(ref), len(y))
    m = min(int(2.0 * fs / f0_floor), n // 4)
    err = ref[m:n - m] - y[m:n - m]
    return 10.0 * np.log10(np.sum(ref[m:n - m] ** 2) / max(np.sum(err ** 2),
                                                           1e-12))


def odd_hop(duration):
    opt = create_aoptions(fs=11000.0, f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(fs=11000.0), use_pallas=True)
    rows = [testsig.make_test_utterance(duration=duration, fs=11000.0,
                                        seed=i, noise_level=nl,
                                        return_parts=True)
            for i, nl in ROWS.items()]
    x, f0, x_ref = (np.stack([r[j] for r in rows]).astype(np.float32)
                    for j in range(3))
    nxv = np.full((len(rows),), x.shape[1], np.int32)
    _, snr, _ = corpus.batched_pipeline(opt, sopt, jnp.asarray(x),
                                        jnp.asarray(f0), jnp.asarray(nxv),
                                        jnp.asarray(x_ref))
    return dict(zip(ROWS, np.asarray(snr).tolist()))


def public_11025():
    fs = 11025.0
    opt = create_aoptions(fs=fs, f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(fs=fs), use_pallas=True)
    out = {}
    for seed, nl in ((0, 0.05), (64, 0.0)):
        x, f0, x_ref = testsig.make_test_utterance(
            duration=1.0, fs=fs, seed=seed, noise_level=nl, return_parts=True)
        chunk = layer0.analyze(opt, x.astype(np.float32), f0.astype(np.float32))
        res = layer0.synthesize(sopt, chunk)
        y_sin = np.asarray(res.y_sin, np.float64)
        out[seed] = dict(len=len(y_sin),
                         snr=snr_db(x_ref, y_sin, fs, opt.conf.f0_floor))
    return out


def _opts16():
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    return opt, dataclasses.replace(create_soptions(), use_pallas=True)


def layer0_rows(duration):
    """chip_smoke.py phases 4 and 5 at 16 kHz: batched_pipeline SNRs of
    bench rows 0, 1 (noisy) and 64 (clean) with the library default, and of
    rows 0 and 1 with the denoiser off."""
    opt, sopt = _opts16()
    rows = [testsig.make_test_utterance(duration=duration, seed=i,
                                        noise_level=nl, return_parts=True)
            for i, nl in ROWS.items()]
    x, f0, x_ref = (np.stack([r[j] for r in rows]).astype(np.float32)
                    for j in range(3))
    out = {}
    for label, o, n in (
            ("library default", opt, len(rows)),
            ("denoiser off", dataclasses.replace(opt, track_denoise=False), 2)):
        nxv = np.full((n,), x.shape[1], np.int32)
        _, snr, _ = corpus.batched_pipeline(
            o, sopt, *(jnp.asarray(a[:n]) for a in (x, f0, nxv, x_ref)))
        out[label] = dict(zip(list(ROWS)[:n], np.asarray(snr).tolist()))
    return out


def layer1_round_trip(duration):
    opt, sopt = _opts16()
    out = {}
    for i, nl in ROWS.items():
        x, f0, x_ref = testsig.make_test_utterance(
            duration=duration, seed=i, noise_level=nl, return_parts=True)
        ch = layer0.analyze(opt, x.astype(np.float32), f0.astype(np.float32))
        back = layer1.chunk_to_layer0(layer1.chunk_to_layer1(ch))
        y_sin = np.asarray(layer0.synthesize(sopt, back).y_sin, np.float64)
        out[i] = snr_db(x_ref, y_sin, opt.conf.fs, opt.conf.f0_floor)
    return out


def pbp_rows(duration):
    opt, sopt = _opts16()
    nfrm = int(round(duration / opt.conf.thop))
    out = {}
    for i in (0, 1):
        f0 = testsig.make_f0_track(nfrm, opt.conf.thop)
        x, f0 = testsig.synth_lf_speech(f0, rd=LF_RD[i % 4], seed=i)
        l1 = layer1.chunk_to_layer1(layer0.analyze(
            opt, x.astype(np.float32), f0.astype(np.float32)))
        y_sin = np.asarray(layer0.synthesize(
            sopt, layer1.chunk_to_layer0(l1)).y_sin, np.float64)
        y_pbp = np.asarray(pbp.pbp_synthesize(sopt, l1).y_sin, np.float64)
        v = np.asarray(l1.rd)[np.asarray(l1.f0) > 0]
        out[i] = dict(snr=snr_db(y_sin, y_pbp, opt.conf.fs, opt.conf.f0_floor),
                      rd_median=float(np.median(v)))
    return out


def _runs(voiced):
    """Run lengths of a boolean track, the first run unvoiced (maybe 0)."""
    edges = np.flatnonzero(np.diff(voiced.astype(np.int8))) + 1
    runs = np.diff(np.concatenate([[0], edges, [len(voiced)]])).tolist()
    return ([0] + runs) if voiced[0] else runs


def corpus_files(n_files=16, batch_size=8):
    import os
    import tempfile

    from libllsm2_tpu.ops import f0 as f0mod
    from libllsm2_tpu.utils import dataio
    from libllsm2_tpu_torch.utils import testsig as tts

    opt, sopt = _opts16()
    need = sorted({tts.corpus_row(i) for i in range(n_files)})
    made = tts.make_test_utterances(
        [(r, 0.05 if r < 64 else 0.0) for r in need], duration=8.0)
    rows = {r: (m[0].astype(np.float32), m[1].astype(np.float32))
            for r, m in zip(need, made)}
    buckets = (200, 400, 800, 1600)
    nhop = opt.conf.nhop
    cfg = f0mod.F0Config(fs=opt.conf.fs, nhop=nhop,
                         f0_floor=max(60.0, opt.conf.f0_floor))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        paths = tts.write_test_corpus(
            d, n_files, lambda i: rows[tts.corpus_row(i)])
        for r in corpus.run_corpus_files(opt, sopt, paths, buckets,
                                         batch_size=batch_size):
            for p, snr in zip(r["paths"], np.asarray(r["snr"]).tolist()):
                i = paths.index(p)
                runs = None
                if not os.path.exists(p[:-4] + ".f0.npy"):
                    x, _, _ = dataio.load_wav_batch([p], r["bucket"] * nhop,
                                                    dtype="int16")
                    tr = np.asarray(f0mod.track(cfg, jnp.asarray(
                        x[0].astype(np.float32) * np.float32(1.0 / 32767.0))))
                    runs = _runs(tr > 0)
                out[i] = (snr, runs)
    return dict(sorted(out.items()))


def edit_chain(duration):
    from libllsm2_tpu.models import edits
    opt, sopt = _opts16()
    nfrm = int(round(duration / opt.conf.thop))
    out = {}
    for i in (0, 1):
        f0 = testsig.make_f0_track(nfrm, opt.conf.thop)
        x, f0 = testsig.synth_lf_speech(f0, rd=LF_RD[i % 4], seed=i)
        l1 = layer1.chunk_to_layer1(layer0.analyze(
            opt, x.astype(np.float32), f0.astype(np.float32)))
        ed = edits.time_stretch(edits.pitch_shift(l1, 2.0), 1.5)
        y = np.asarray(layer0.synthesize(sopt, ed).y_sin, np.float64)
        f = np.asarray(ed.f0)
        out[i] = dict(nfrm=int(ed.nfrm), f0_median=float(np.median(f[f > 0])),
                      rms=float(np.sqrt(np.mean(y ** 2))))
    return out


def _lf_layer1(duration, rows=(0, 1)):
    opt, sopt = _opts16()
    nfrm = int(round(duration / opt.conf.thop))
    out = []
    for i in rows:
        f0 = testsig.make_f0_track(nfrm, opt.conf.thop)
        x, f0 = testsig.synth_lf_speech(f0, rd=LF_RD[i % 4], seed=i)
        out.append(layer1.chunk_to_layer1(layer0.analyze(
            opt, x.astype(np.float32), f0.astype(np.float32))))
    return out


def coder_rows(duration):
    from libllsm2_tpu.models import coder
    from libllsm2_tpu.utils import metrics, serialize
    _, sopt = _opts16()
    l1s = _lf_layer1(duration)
    cc = coder.CoderConfig(conf=l1s[0].conf)
    v = np.stack([np.asarray(coder.encode(cc, l1)) for l1 in l1s])
    q = coder.fit_quantizer(v, bits=8, dpcm=coder.default_dpcm_mask(cc),
                            f0_slot=coder.f0_slot(cc))
    serialize.coded_save(CODER_PINS, cc, v, bits=8, quant=q)
    render = lambda vec: np.asarray(layer0.synthesize(
        sopt, coder.decode(cc, vec)).y_sin, np.float64)
    out = {}
    with __import__("tempfile").TemporaryDirectory() as d:
        path = d + "/v16.npz"
        serialize.coded_save(path, cc, v, bits=16)
        v16 = serialize.coded_load(path)[1]
    v8 = serialize.coded_load(CODER_PINS)[1]
    for i in range(len(l1s)):
        y = render(v[i])
        out[i] = dict(rms=float(np.sqrt(np.mean(y ** 2))), **{
            f"mcd{b}": metrics.mel_cepstral_distortion_db(
                y, render(vb[i]), fs=cc.conf.fs) for b, vb in ((8, v8),
                                                               (16, v16))})
    return out


def nasal_rows(duration):
    opt, _ = _opts16()
    out = {}
    for i in (0, 1):
        x, f0 = testsig.synth_nasal_utterance(
            duration=duration, seed=i, zero=(900.0, 60.0),
            f0_base=NASAL_F0[i % 3])
        ch = layer0.analyze(opt, x.astype(np.float32), f0.astype(np.float32))
        v = np.asarray(f0) > 0
        out[i] = {k: float(np.median(np.asarray(
            layer1.chunk_to_layer1(ch, None, secs).rd)[v]))
            for k, secs in (("sections", NASAL_SECTIONS), ("none", None))}
    return out


def ampl_snr(ref, got):
    """10 log10(sum ref^2 / sum (ref - got)^2) over two ampl arrays (the
    SNR of tests/test_rtanalyze.py)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(10.0 * np.log10(np.sum(ref ** 2)
                                 / max(np.sum((ref - got) ** 2), 1e-30)))


def stream_rows(duration):
    from libllsm2_tpu.runtime.rtanalyze import RTAnalyzer, concat_frames
    opt, _ = _opts16()
    out = {}
    for i in (0, 1):
        x, f0 = testsig.make_test_utterance(duration=duration, seed=i,
                                            noise_level=ROWS[i])
        x, f0 = x.astype(np.float32), f0.astype(np.float32)
        rta = RTAnalyzer(opt, block_hops=STREAM_BLOCK, halo_hops=STREAM_HALO)
        outs = []
        for k in range(0, max(len(x) // 997, len(f0) // 13) + 1):
            got = rta.feed(x[997 * k:997 * (k + 1)], f0[13 * k:13 * (k + 1)])
            if got is not None:
                outs.append(got)
        tail = rta.flush()
        st = concat_frames(outs + ([tail] if tail is not None else []))
        off = layer0.analyze(opt, x, f0)
        off_nd = layer0.analyze(dataclasses.replace(opt, track_denoise=False),
                                x, f0)
        out[i] = dict(nfrm=int(st.nfrm), snr=ampl_snr(off.ampl, st.ampl),
                      snr_denoiser_off=ampl_snr(off_nd.ampl, st.ampl))
    return out


def stream_pbp_rows(duration):
    from libllsm2_tpu.runtime import rtsynth
    from libllsm2_tpu.utils import metrics
    _, sopt = _opts16()
    out = {}
    for i, l1 in enumerate(_lf_layer1(duration)):
        y_off = np.asarray(pbp.pbp_synthesize(sopt, l1).y_sin)
        y = rtsynth.stream_chunk(sopt, l1, block=16, synth_mode="pbp")
        fs = int(l1.conf.fs)
        out[i] = dict(snr=metrics.snr_db(y_off, y), per_second=[
            round(metrics.snr_db(y_off[a:a + fs], y[a:a + fs], trim=0.0), 2)
            for a in range(0, len(y_off) - fs + 1, fs)])
    return out


def _bench_rows(duration, rows, thop=0.005):
    data = [testsig.make_test_utterance(duration=duration, seed=i,
                                        noise_level=0.05 if i < 64 else 0.0,
                                        thop=thop, return_parts=True)
            for i in rows]
    x, f0, x_ref = (np.stack([r[j] for r in data]).astype(np.float32)
                    for j in range(3))
    nxv = np.full((len(rows),), x.shape[1], np.int32)
    return tuple(jnp.asarray(a) for a in (x, f0, nxv, x_ref))


def dspkit_rows(duration):
    """chip_smoke.py phase 16a / 16b pins: batched_pipeline SNRs of the
    library default (use_pallas=False) on rows 0, 1 and 64, and of each
    analysis option with the kernels on on rows 0 and 1."""
    out = {}
    _, snr, _ = corpus.batched_pipeline(
        create_aoptions(f0_floor=70.0), create_soptions(),
        *_bench_rows(duration, list(ROWS)))
    out["library default"] = dict(zip(ROWS, np.asarray(snr).tolist()))
    print(f"  library default: {out['library default']}", flush=True)
    opt, sopt = _opts16()
    for label, change in (("pp", dict(hm_method="pp")),
                          ("passes 2", dict(hm_passes=2)),
                          ("correction none", dict(hm_correction="none")),
                          ("frame_chunk 64", dict(frame_chunk=64))):
        t0 = time.perf_counter()
        _, snr, _ = corpus.batched_pipeline(
            dataclasses.replace(opt, **change), sopt,
            *_bench_rows(duration, [0, 1]))
        out[label] = dict(zip((0, 1), np.asarray(snr).tolist()))
        print(f"  {label}: {out[label]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def wide_opts():
    """chip_smoke.py phase 20's options: (creaky voice's analysis options,
    the 48 kHz / 10 ms hop analysis and synthesis options)."""
    opt, _ = _opts16()
    creaky = dataclasses.replace(opt, conf=dataclasses.replace(
        opt.conf, maxnhar=160, fnyq=6000.0))
    opt48 = create_aoptions(fs=48000.0, thop=0.01, fnyq=12000.0,
                            chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                            f0_floor=70.0, use_pallas=True)
    sopt48 = dataclasses.replace(create_soptions(fs=48000.0), use_pallas=True)
    return creaky, opt48, sopt48


def wide_rows(duration):
    """chip_smoke.py phase 20a / 20b pins: batched_pipeline SNRs of bench
    rows 0, 1 and 64 at creaky voice's conf, and at 48 kHz with a 10 ms hop
    on the rows resampled to 48 kHz (every second F0 frame)."""
    from libllsm2_tpu.ops.resample import resample_to
    creaky, opt48, sopt48 = wide_opts()
    _, sopt = _opts16()
    x, f0, nxv, x_ref = _bench_rows(duration, list(ROWS))
    out = {}
    t0 = time.perf_counter()
    _, snr, _ = corpus.batched_pipeline(creaky, sopt, x, f0, nxv, x_ref)
    out["creaky"] = dict(zip(ROWS, np.asarray(snr).tolist()))
    print(f"  creaky: {out['creaky']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    x48, ref48 = (jnp.stack([resample_to(r, 16000.0, 48000.0) for r in a])
                  for a in (x, x_ref))
    nxv48 = jnp.full(nxv.shape, x48.shape[-1], nxv.dtype)
    _, snr, _ = corpus.batched_pipeline(opt48, sopt48, x48, f0[:, ::2],
                                        nxv48, ref48)
    out["48 kHz"] = dict(zip(ROWS, np.asarray(snr).tolist()))
    print(f"  48 kHz: {out['48 kHz']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return out


def hop_rows(duration, thop=0.02, every=4):
    """chip_smoke.py phase 20g / 20h pins: batched_pipeline SNRs of bench
    rows 0, 1 and 64 at 48 kHz with a 20 ms (hop 960) or 50 ms (hop 2400)
    hop (part wide's 48 kHz options otherwise) on the rows resampled to 48
    kHz, every `every`-th F0 frame (the 5 ms frames at the hop)."""
    from libllsm2_tpu.ops.resample import resample_to
    opt = create_aoptions(fs=48000.0, thop=thop, fnyq=12000.0,
                          chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                          f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(fs=48000.0), use_pallas=True)
    assert opt.conf.nhop == round(48000 * thop) == 240 * every
    x, f0, nxv, x_ref = _bench_rows(duration, list(ROWS))
    x48, ref48 = (jnp.stack([resample_to(r, 16000.0, 48000.0) for r in a])
                  for a in (x, x_ref))
    nxv48 = jnp.full(nxv.shape, x48.shape[-1], nxv.dtype)
    _, snr, _ = corpus.batched_pipeline(opt, sopt, x48, f0[:, ::every],
                                        nxv48, ref48)
    return dict(zip(ROWS, np.asarray(snr).tolist()))


def fullband_opts(use_pallas=True):
    """chip_smoke.py phase 20e's options: {label: (analysis options,
    synthesis options, the fixtures' hop)}; use_pallas=False (the float64
    run) takes the plain branches."""
    opts = {}
    for label, kw, thop in (
            ("48 kHz", dict(fs=48000.0, f0_floor=40.0, maxnhar=600), 0.005),
            ("16 kHz 2 ms", dict(thop=0.002, f0_floor=40.0, maxnhar=200,
                                 fnyq=8000.0), 0.002)):
        opt = create_aoptions(use_pallas=use_pallas, **kw)
        sopt = create_soptions(fs=opt.conf.fs)
        if use_pallas:
            sopt = dataclasses.replace(sopt, use_pallas=True)
        opts[label] = (opt, sopt, thop)
    return opts


def _fullband_batch(label, duration, rows, thop):
    """Bench rows `rows` at phase 20e's configuration `label`: (x, f0, nxv,
    x_ref), the 48 kHz rows resampled, every F0 frame."""
    from libllsm2_tpu.ops.resample import resample_to
    if label != "48 kHz":
        return _bench_rows(duration, rows, thop=thop)
    x, f0, nxv, x_ref = _bench_rows(duration, rows)
    x, x_ref = (jnp.stack([resample_to(r, 16000.0, 48000.0) for r in a])
                for a in (x, x_ref))
    return x, f0, jnp.full(nxv.shape, x.shape[-1], nxv.dtype), x_ref


def fullband_rows(duration):
    """chip_smoke.py phase 20e: batched_pipeline SNRs of bench rows 0, 1
    and 64 at full band: 48 kHz (the rows resampled, every F0 frame) and
    16 kHz at a 2 ms hop (the rows made at that hop); then with each
    sample of x times 1 + 2^-23 u, u uniform in [-1, 1) from seed 0."""
    out = {}
    for label, (opt, sopt, thop) in fullband_opts().items():
        t0 = time.perf_counter()
        x, f0, nxv, x_ref = _fullband_batch(label, duration, list(ROWS),
                                            thop)
        u = np.random.default_rng(0).uniform(-1.0, 1.0, x.shape)
        eps = jnp.asarray((1.0 + 2.0 ** -23 * u).astype(np.float32))
        for tag, xs in (("", x), (" x (1 + 2^-23 u)", x * eps)):
            _, snr, _ = corpus.batched_pipeline(opt, sopt, xs, f0, nxv,
                                                x_ref)
            out[label + tag] = dict(zip(ROWS, np.asarray(snr).tolist()))
            print(f"  {label}{tag}: {out[label + tag]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def _project_win64(dc, frames, hw, max_k, lo, hi, *, center,
                   window="hanning", kl=None, **_):
    """pallas_osc.harmonic_project_win_pallas's outputs computed in float64
    (numpy, through jax.pure_callback) and rounded to float32: (re, im)
    [N, max_k] = sum_w frames win e^{-2 pi j (k+1) dc}, wsum and xsum [N],
    each harmonic's phase taken directly (no rotation recurrence) over the
    window's support; slots at or past kl (the caller masks them) zero."""
    from libllsm2_tpu.ops.windows import COSINE_SERIES
    coefs = COSINE_SERIES[window]
    del lo, hi                      # the window's own support is exact

    def host(dc, frames, hw, kl):
        dc, fr = np.asarray(dc, np.float64), np.asarray(frames, np.float64)
        N, W = dc.shape
        re = np.zeros((N, max_k)), np.zeros((N, max_k))
        ws, xs = np.zeros(N), np.zeros(N)
        noff = np.arange(W, dtype=np.float64) - center
        for n in range(N):
            u = (noff / float(hw[n]) + 1.0) * 0.5
            sup = (u >= 0.0) & (u <= 1.0)
            w = sum(c * np.cos(2.0 * np.pi * m * u[sup])
                    for m, c in enumerate(coefs))
            xw = fr[n, sup] * w
            ws[n], xs[n] = w.sum(), xw.sum()
            k = int(min(max(kl[n], 0), max_k))
            if k:
                ang = 2.0 * np.pi * np.outer(dc[n, sup],
                                             np.arange(1, k + 1))
                re[0][n, :k] = xw @ np.cos(ang)
                re[1][n, :k] = -(xw @ np.sin(ang))
        return tuple(a.astype(np.float32) for a in (*re, ws, xs))

    N = dc.shape[0]
    kl = jnp.full((N,), max_k, jnp.int32) if kl is None else kl
    shapes = (jax.ShapeDtypeStruct((N, max_k), jnp.float32),) * 2 + (
        jax.ShapeDtypeStruct((N,), jnp.float32),) * 2
    return jax.pure_callback(host, shapes, dc, frames, hw, kl,
                             vmap_method="sequential")


def _sample_cycles64(f0, nhop, fs, nx):
    """harmonics.sample_cycles computed in float64 (numpy, through
    jax.pure_callback): the same interpolated F0 summed sample by sample,
    mod 1, rounded to float32."""
    def host(f0):
        f0 = np.asarray(f0, np.float64)
        n = f0.shape[0]
        f0s = np.where(f0 > 0, f0, 0.0)
        pos = np.arange(nx, dtype=np.float64) / nhop
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, n - 2)
        t = np.clip(pos - i0, 0.0, 1.0)
        d = (f0s[i0] * (1.0 - t) + f0s[i0 + 1] * t) / fs
        c = np.concatenate([[0.0], np.cumsum(d)[:-1]]) % 1.0
        return c.astype(np.float32)

    return jax.pure_callback(host, jax.ShapeDtypeStruct((nx,), jnp.float32),
                             f0, vmap_method="sequential")


def fullband_proj64(duration, cycles=False):
    """Part proj64: part fullband's rows through the JAX package in float32
    with the windowed harmonic projection (harmonic_project_win_pallas)
    computed in float64 (_project_win64) -> {label: {row: SNR}}."""
    from libllsm2_tpu.ops import harmonics, pallas_osc
    out = {}
    orig = pallas_osc.harmonic_project_win_pallas, harmonics.sample_cycles
    pallas_osc.harmonic_project_win_pallas = _project_win64
    if cycles:
        harmonics.sample_cycles = _sample_cycles64
    try:
        for label, (opt, sopt, thop) in fullband_opts().items():
            t0 = time.perf_counter()
            _, snr, _ = corpus.batched_pipeline(
                opt, sopt, *_fullband_batch(label, duration, list(ROWS),
                                            thop))
            out[label] = dict(zip(ROWS, np.asarray(snr).tolist()))
            print(f"  {label}: {out[label]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        pallas_osc.harmonic_project_win_pallas, harmonics.sample_cycles = orig
    return out


def fullband_means(duration, chunk=16):
    """chip_smoke.py phase 20e: batched_pipeline SNRs of all 128 bench rows
    at each full-band configuration, in chunks of `chunk` rows -> {label:
    (noisy rows' mean, clean rows' mean, every row's SNR)}."""
    out = {}
    for label, (opt, sopt, thop) in fullband_opts().items():
        t0 = time.perf_counter()
        snr = []
        for r0 in range(0, 128, chunk):
            rows = list(range(r0, r0 + chunk))
            _, s, _ = corpus.batched_pipeline(
                opt, sopt, *_fullband_batch(label, duration, rows, thop))
            snr += np.asarray(s).tolist()
        out[label] = (float(np.mean(snr[:64])), float(np.mean(snr[64:])),
                      snr)
        print(f"  {label}: noisy mean {out[label][0]}, clean mean "
              f"{out[label][1]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def _int8_tree(tree, out, prefix):
    """Snap a parameter pytree to 8-bit codes times a float32 scale a
    leaf (s = max |w| / 127), the weights both packages then start from;
    store the codes (int8) and scales in out under prefix/path."""
    def leaf(path, a):
        a = np.asarray(a, np.float32)
        s = np.float32(max(float(np.abs(a).max()), 1e-30) / 127.0)
        codes = np.round(a / s).astype(np.int8)
        name = prefix + "/" + "/".join(str(k.key) for k in path)
        out[name], out[name + "@scale"] = codes, np.asarray(s)
        return jnp.asarray(codes.astype(np.float32) * s)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _train(step, cfg, params, opt, *args):
    state, losses = opt.init(params), []
    for _ in range(LEARNED_STEPS):
        params, state, loss = step(cfg, params, state, *args)
        losses.append(float(loss))
    return np.asarray(losses, np.float32)


def learned_models():
    """Part learned: LEARNED_PINS and abs_refine's SNRs."""
    from libllsm2_tpu.models import abs as absmod
    from libllsm2_tpu.models import acoustic, coder, neural, vq
    from libllsm2_tpu.utils import ttsdata

    dims = coder.CoderConfig(conf=create_aoptions().conf).dims
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, dims)).astype(np.float32)
    B, N = 2, 64
    ids = rng.integers(0, ttsdata.N_PHONES, (B, N)).astype(np.int32)
    feats = rng.uniform(0.0, 1.0, (B, N, 2)).astype(np.float32)
    tgt = rng.standard_normal((B, N, dims)).astype(np.float32)
    mask = (np.arange(N)[None, :] < np.array([64, 41])[:, None]
            ).astype(np.float32)
    out = dict(x=x, ids=ids, feats=feats, targets=tgt, mask=mask)
    key = jax.random.PRNGKey(0)

    ae = neural.AEConfig(dims=dims)
    p = _int8_tree(neural.init_params(ae, key), out, "ae")
    out["ae_forward"] = np.asarray(neural.forward(ae, p, jnp.asarray(x)))
    out["ae_losses"] = _train(neural.train_step, ae, p,
                              neural.make_optimizer(ae), jnp.asarray(x))

    vc = vq.VQConfig(dims=dims)
    p = _int8_tree(vq.init_params(vc, key), out, "vq")
    out["vq_forward"] = np.asarray(vq.forward(vc, p, jnp.asarray(x))[0])
    out["vq_tokens"] = np.asarray(vq.encode_tokens(vc, p, jnp.asarray(x)))
    out["vq_losses"] = _train(vq.train_step, vc, p, vq.make_optimizer(vc),
                              jnp.asarray(x))

    ac = acoustic.AcousticConfig(dims=dims, n_phones=ttsdata.N_PHONES)
    p = _int8_tree(acoustic.init_params(ac, key), out, "acoustic")
    out["acoustic_forward"] = np.asarray(acoustic.forward(
        ac, p, jnp.asarray(ids), jnp.asarray(feats)))
    w = np.ones(dims, np.float32)
    w[0] = 4.0
    out["acoustic_losses"] = _train(
        acoustic.train_step, ac, p, acoustic.make_optimizer(ac),
        tuple(jnp.asarray(a) for a in (ids, feats, tgt, mask)),
        jnp.asarray(w))
    np.savez_compressed(LEARNED_PINS, **out)

    # abs_refine on tests/test_abs.py's weakened analysis
    xa, f0, xh = testsig.synth_hard_utterance(
        duration=0.6, register="female", seed=3, jitter=0.01, shimmer=0.1,
        noise_level=0.0, burst=False, unvoiced_tail_frac=0.0)
    opt = dataclasses.replace(create_aoptions(), hm_passes=1,
                              hm_correction="none")
    sopt = create_soptions()
    chunk = layer0.analyze(opt, xa, f0)

    def snr(c):
        y = np.asarray(layer0.synthesize(sopt, c).y_sin)
        n = min(len(xh), len(y))
        lo, hi = int(0.05 * n), int(0.95 * n)
        e = xh[lo:hi] - y[lo:hi]
        return float(10 * np.log10(np.sum(xh[lo:hi] ** 2)
                                   / max(np.sum(e ** 2), 1e-20)))
    refined, losses = absmod.abs_refine(sopt, chunk, xa, n_steps=100,
                                        lr=0.1)
    return {"losses": {k: out[k].tolist() for k in
                       ("ae_losses", "vq_losses", "acoustic_losses")},
            "abs_snr_before": snr(chunk), "abs_snr_after": snr(refined),
            "abs_loss_first_last": (float(losses[0]), float(losses[-1]))}


FP64_SCRIPT = """
import numpy as np
from libllsm2_tpu import create_aoptions, create_soptions, fp
from libllsm2_tpu.models import layer0
from libllsm2_tpu.utils import testsig
assert fp.FP64
x, f0 = testsig.make_test_utterance(duration=0.5)
y = np.asarray(layer0.synthesize(create_soptions(), layer0.analyze(
    create_aoptions(), x, f0)).y_sin)
n = len(y)
lo, hi = int(0.1 * n), int(0.9 * n)
e = x[lo:hi] - y[lo:hi]
print(repr(float(10 * np.log10(np.sum(x[lo:hi] ** 2) / np.sum(e ** 2)))))
"""


FULLBAND64_SCRIPT = """
import sys
import numpy as np
sys.argv = ["port_jax_pins.py"]
import port_jax_pins as pins
from libllsm2_tpu import fp
from libllsm2_tpu.parallel import corpus
assert fp.FP64
duration = float(sys.stdin.readline())
for label, (opt, sopt, thop) in pins.fullband_opts(use_pallas=False).items():
    _, snr, _ = corpus.batched_pipeline(
        opt, sopt, *pins._fullband_batch(label, duration, list(pins.ROWS),
                                         thop))
    print(repr((label, np.asarray(snr).tolist())), flush=True)
"""


def fullband_rows64(duration):
    """Part fullband64: part fullband's rows through the JAX package in
    float64 (LLSM_FP64=1, its plain branches) -> {label: {row: SNR}}."""
    import ast
    import os
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LLSM_FP64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join((os.getcwd(), here)))
    r = subprocess.run([sys.executable, "-c", FULLBAND64_SCRIPT], env=env,
                       input=f"{duration}\n", capture_output=True, text=True,
                       check=True)
    out = {}
    for line in r.stdout.strip().splitlines():
        label, snr = ast.literal_eval(line)
        out[label] = dict(zip(ROWS, snr))
    return out


def fp64_round_trip():
    """Part fp64: tests/test_fp64.py's SNR, the JAX package in float64."""
    import os
    import subprocess
    env = dict(os.environ, LLSM_FP64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.getcwd())
    r = subprocess.run([sys.executable, "-c", FP64_SCRIPT], env=env,
                       capture_output=True, text=True, check=True)
    return float(r.stdout.strip().splitlines()[-1])


def mesh_rows(seconds):
    """chip_smoke.py phase 19a's utterances through the JAX package's
    frame-sharded analysis and synthesis on 4 devices, and through its
    one-process analyze -> synthesize -> {seed: (sharded SNR, one-process
    SNR)}."""
    from libllsm2_tpu.parallel import mesh as meshlib, seqparallel
    opt, sopt = _opts16()
    m = meshlib.make_mesh(4, frame_parallel=4)
    out = {}
    for seed, nl in ((0, 0.05), (64, 0.0)):
        x, f0, x_ref = testsig.make_test_utterance(
            duration=seconds, seed=seed, noise_level=nl, return_parts=True)
        ref = np.asarray(x_ref, np.float32)
        chunk = seqparallel.analyze_frame_sharded(opt, x, f0, m)
        y = np.asarray(seqparallel.synthesize_frame_sharded(sopt, chunk,
                                                            m).y_sin)
        y1 = np.asarray(layer0.synthesize(sopt, layer0.analyze(
            opt, x, f0)).y_sin)
        out[seed] = tuple(float(snr_db(ref, v, opt.conf.fs,
                                       opt.conf.f0_floor)) for v in (y, y1))
    return out


def main():
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    duration = float(kw.get("duration", 8.0))
    only = kw.get("only", "l0,11k,l1,pbp,corpus,edits,coder,nasal,stream,"
                  "dspkit,learned,fp64,mesh,wide,h20,h50,fullband,proj64").split(",")
    if "l0" in only:
        t0 = time.perf_counter()
        print(f"16 kHz batched_pipeline at {duration} s:",
              layer0_rows(duration), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "11k" in only:
        t0 = time.perf_counter()
        print("11025 Hz public analyze -> synthesize:", public_11025(),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        print(f"odd hop batched_pipeline at {duration} s:", odd_hop(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "l1" in only:
        t0 = time.perf_counter()
        print(f"layer-1 round trip at {duration} s:",
              layer1_round_trip(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "pbp" in only:
        t0 = time.perf_counter()
        print(f"PbP against the layer-1 sinusoidal render at {duration} s:",
              pbp_rows(duration), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "corpus" in only:
        t0 = time.perf_counter()
        print("run_corpus_files on the first 16 files of the phase-11 corpus "
              "(snr, tracked voicing runs):", corpus_files(),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "edits" in only:
        t0 = time.perf_counter()
        print(f"pitch x2, stretch x1.5 of LF rows 0/1 at {duration} s:",
              edit_chain(duration), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "coder" in only:
        t0 = time.perf_counter()
        print(f"the codec on LF rows 0/1 at {duration} s (y_sin rms of the "
              "float decode; MCD of the 8- and 16-bit archives' decodes; "
              f"the 8-bit archive in {CODER_PINS}):", coder_rows(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "nasal" in only:
        t0 = time.perf_counter()
        print(f"median voiced rd of nasal rows 0/1 at {duration} s, with "
              "and without sections:", nasal_rows(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    if "stream" in only:
        t0 = time.perf_counter()
        print(f"RTAnalyzer (block {STREAM_BLOCK}, halo {STREAM_HALO}) on "
              f"bench rows 0/1 at {duration} s, ampl SNR of the streamed "
              "frames against the offline analysis, denoiser on (and "
              "against the offline analysis with it off):",
              stream_rows(duration), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
        t0 = time.perf_counter()
        print(f"PbP stream_chunk(block=16) of LF rows 0/1 at {duration} s, "
              "y_sin SNR against pbp_synthesize:", stream_pbp_rows(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "dspkit" in only:
        t0 = time.perf_counter()
        print(f"phase 16 at {duration} s (the library default on rows 0/1/64, "
              "then each analysis option with the kernels on rows 0/1):",
              dspkit_rows(duration), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "learned" in only:
        t0 = time.perf_counter()
        print(f"the learned models at default widths ({LEARNED_PINS}: "
              f"weights, inputs, forwards, {LEARNED_STEPS} steps' losses, "
              "tokens) and abs_refine's SNRs:", learned_models(),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "fp64" in only:
        t0 = time.perf_counter()
        print("the float64 round trip of tests/test_fp64.py, y_sin SNR:",
              fp64_round_trip(), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "mesh" in only:
        t0 = time.perf_counter()
        secs = float(kw.get("mesh_seconds", 64.0))
        print(f"round trip at {secs} s, y_sin SNR (frame-sharded on 4 "
              "devices, one process):", mesh_rows(secs),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "wide" in only:
        t0 = time.perf_counter()
        print(f"phase 20 at {duration} s (creaky voice's K = 160, then 48 kHz "
              "at a 10 ms hop), batched_pipeline SNR of rows 0/1/64:",
              wide_rows(duration), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "h20" in only:
        t0 = time.perf_counter()
        print(f"phase 20g at {duration} s (48 kHz at a 20 ms hop), "
              "batched_pipeline SNR of rows 0/1/64:", hop_rows(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "h50" in only:
        t0 = time.perf_counter()
        print(f"phase 20h at {duration} s (48 kHz at a 50 ms hop), "
              "batched_pipeline SNR of rows 0/1/64:",
              hop_rows(duration, 0.05, 10),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "fullband" in only:
        t0 = time.perf_counter()
        print(f"phase 20e at {duration} s (full band: 48 kHz at K = 600, then "
              "16 kHz at a 2 ms hop at K = 200), batched_pipeline SNR of "
              "rows 0/1/64:", fullband_rows(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "fullband64" in only:
        t0 = time.perf_counter()
        print(f"phase 20e at {duration} s in float64 (LLSM_FP64=1, the plain "
              "branches), batched_pipeline SNR of rows 0/1/64:",
              fullband_rows64(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "proj64" in only:
        t0 = time.perf_counter()
        print(f"phase 20e at {duration} s with the windowed projection in "
              "float64, batched_pipeline SNR of rows 0/1/64:",
              fullband_proj64(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "cyc64" in only:
        t0 = time.perf_counter()
        print(f"phase 20e at {duration} s with the windowed projection and "
              "the cycle track in float64, batched_pipeline SNR of rows "
              "0/1/64:", fullband_proj64(duration, cycles=True),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "fullbandmean" in only:
        t0 = time.perf_counter()
        print(f"phase 20e at {duration} s on all 128 bench rows, (noisy mean, "
              "clean mean, every row's SNR):", fullband_means(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

if __name__ == "__main__":
    main()
