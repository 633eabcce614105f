"""The port's float64 mode (LLSM_FP64=1, libllsm2_tpu_torch/fp.py)
against the JAX package's (tests/test_fp64.py), on the CPU.  The knob is
read at import, so each case runs in a subprocess that imports both
packages with it set."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROUND_TRIP = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import libllsm2_tpu as jpkg
    from libllsm2_tpu.models import layer0 as jl0
    from libllsm2_tpu.utils import testsig
    import libllsm2_tpu_torch as tpkg
    from libllsm2_tpu_torch import fp
    from libllsm2_tpu_torch.models import layer0
    from libllsm2_tpu_torch.ops import kernels

    assert fp.FP64 and fp.FP == torch.float64 and fp.CP == torch.complex128
    x, f0 = testsig.make_test_utterance(duration=0.5)
    jc = jl0.analyze(jpkg.create_aoptions(), x, f0)
    jo = jl0.synthesize(jpkg.create_soptions(), jc)
    kernels.reset_launches()
    c = layer0.analyze(tpkg.create_aoptions(), x, f0, device="cpu")
    o = layer0.synthesize(tpkg.create_soptions(), c)
    for k in ("f0", "ampl", "phse", "hm_mask", "psd", "edc", "eenv_a",
              "eenv_p"):
        assert getattr(c, k).dtype == torch.float64, k
    for k in ("y", "y_sin", "y_nos"):
        assert getattr(o, k).dtype == torch.float64, k
    # float64 agreement (measured: fields ~1e-12 of their peak, y ~2e-12):
    # 1e-9 of each field's peak; phases through a e^{j phi}, which weights
    # them by their amplitude (a phase of a vanishing harmonic is noise)
    def close(name, got, ref):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < 1e-9, (name, err)
    for k in ("f0", "ampl", "hm_mask", "psd", "edc", "eenv_a"):
        close(k, getattr(c, k), getattr(jc, k))
    close("ampl e^{j phse}", torch.polar(c.ampl, c.phse),
          np.asarray(jc.ampl) * np.exp(1j * np.asarray(jc.phse)))
    close("eenv", torch.polar(c.eenv_a, c.eenv_p),
          np.asarray(jc.eenv_a) * np.exp(1j * np.asarray(jc.eenv_p)))
    for k in ("y", "y_sin", "y_nos"):
        close(k, getattr(o, k), getattr(jo, k))
    y = o.y_sin.numpy()
    n = len(y)
    lo, hi = int(0.1 * n), int(0.9 * n)
    snr = lambda v: 10 * np.log10(np.sum(x[lo:hi] ** 2)
                                  / max(np.sum((x[lo:hi] - v[lo:hi]) ** 2),
                                        1e-30))
    s, sj = snr(y), snr(np.asarray(jo.y_sin))
    assert s >= 45.0 and abs(s - sj) < 0.01, (s, sj)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    for make in (tpkg.create_aoptions, tpkg.create_soptions):
        try:
            make(use_pallas=True)
        except ValueError:
            pass
        else:
            raise AssertionError("use_pallas accepted under LLSM_FP64")
    print("FP64-OK", round(float(s), 3), round(float(sj), 3))
""")

KNOB = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from libllsm2_tpu import fp as jfp
    from libllsm2_tpu_torch.ops import kernels

    assert jfp.FP64                     # the JAX package turned x64 on

    # the float64 noise draw: JAX's x64 normals bit for bit (layer0's
    # draw: normal(split(fold_in(PRNGKey(seed), frame))[j], (nbin,)))
    for seed, base, N, nbin in ((0x5eed, 0, 300, 161), (7, 123456, 64, 81),
                                (2 ** 32 - 1, 2 ** 31, 32, 33)):
        re, im = kernels.noise_bins_ref(seed, base, 2, N, nbin,
                                        dtype=torch.float64)
        assert re.shape == (2, N, nbin) and re.dtype == torch.float64
        key = jax.random.PRNGKey(seed)
        def frame(i):
            kr, ki = jax.random.split(jax.random.fold_in(key, i))
            return (jax.random.normal(kr, (nbin,), jnp.float64),
                    jax.random.normal(ki, (nbin,), jnp.float64))
        jre, jim = jax.vmap(frame)(jnp.asarray(base + np.arange(N),
                                               jnp.uint32))
        assert jre.dtype == jnp.float64
        for got, ref in ((re[1], jre), (im[0], jim)):
            ref = np.asarray(ref)
            assert np.array_equal(got.numpy().view(np.int64),
                                  ref.view(np.int64)), \\
                (seed, int((got.numpy() != ref).sum()))
    # every kernel wrapper raises on float64 input; the draw wrapper too
    x = torch.zeros((1, 40), dtype=torch.float64)
    m = torch.ones((1, 4, 3), dtype=torch.float64)
    for call in (lambda: kernels.osc_bank(x, m, m, m, 10),
                 lambda: kernels.sample_cycles(x[:, :4], 10, 16000.0, 40),
                 lambda: kernels.noise_bins(0, 0, 1, 4, 9, "cpu")):
        try:
            call()
        except TypeError:
            pass
        else:
            raise AssertionError("a kernel wrapper took float64")
    print("KNOB-OK")
""")


CARD_DRAW = textwrap.dedent("""
    import math
    from decimal import Decimal, getcontext

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from libllsm2_tpu import fp as jfp
    from libllsm2_tpu_torch.ops import kernels

    assert jfp.FP64                     # the JAX package turned x64 on
    # the card's log: correctly rounded (against 60-digit decimals)
    getcontext().prec = 60
    ys = np.random.default_rng(0).uniform(1e-9, 0.586, 2000)
    got = kernels._log_rn(torch.from_numpy(ys)).numpy()
    for y, g in zip(ys, got):
        L = Decimal(float(y)).ln()
        err = abs(Decimal(float(g)) - L)
        for n in (np.nextafter(g, -np.inf), np.nextafter(g, np.inf)):
            assert err < abs(Decimal(float(n)) - L), y
    # the draw through the card's log on host tensors: JAX's x64 normals
    # but where libm's log misrounds (measured: 1 of 109080, one ulp)
    kernels._log_c = kernels._log_rn
    n = bad = 0
    for seed, base, N, nbin in ((0x5eed, 0, 300, 161), (7, 123456, 64, 81),
                                (2 ** 32 - 1, 2 ** 31, 32, 33)):
        re, im = kernels.noise_bins_ref(seed, base, 1, N, nbin,
                                        dtype=torch.float64)
        key = jax.random.PRNGKey(seed)
        def frame(i):
            kr, ki = jax.random.split(jax.random.fold_in(key, i))
            return (jax.random.normal(kr, (nbin,), jnp.float64),
                    jax.random.normal(ki, (nbin,), jnp.float64))
        jre, jim = jax.vmap(frame)(jnp.asarray(base + np.arange(N),
                                               jnp.uint32))
        for got, ref in ((re[0], jre), (im[0], jim)):
            g = got.numpy().view(np.int64)
            r = np.asarray(ref).view(np.int64)
            n += g.size
            bad += int((g != r).sum())
            assert np.abs(g - r).max() <= 2, (seed, np.abs(g - r).max())
    assert bad <= 1e-4 * n, (bad, n)
    print("CARD-DRAW-OK", bad, n)
""")


def _run(script, marker):
    """Runs script in a fresh interpreter with LLSM_FP64=1 and asserts it
    exits 0 and prints marker; a failure says how the subprocess ended (its
    return code, the signal that ended it, or the time limit) with the
    tails of its stdout and stderr.  The subprocess gets one XLA CPU
    device (no inherited virtual device count) and one PyTorch thread: it
    needs no more, and a full parallel run of the suite leaves it no
    more."""
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    env = dict(os.environ, LLSM_FP64="1", PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu", XLA_FLAGS=flags, OMP_NUM_THREADS="1")
    tail = lambda t, n: (t.decode(errors="replace")
                         if isinstance(t, bytes) else t or "")[-n:]
    try:
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(
            f"still running after {e.timeout} s\n--- stdout tail ---\n"
            f"{tail(e.stdout, 2000)}\n--- stderr tail ---\n"
            f"{tail(e.stderr, 3000)}") from None
    # a negative return code is the signal that ended the subprocess
    why = (f"return code {r.returncode}"
           + (f" (signal {-r.returncode})" if r.returncode < 0 else "")
           + f"\n--- stdout tail ---\n{tail(r.stdout, 2000)}"
           + f"\n--- stderr tail ---\n{tail(r.stderr, 3000)}")
    assert r.returncode == 0, why
    assert marker in r.stdout, why


def test_fp64_round_trip_matches_jax():
    """test_fp64's fixture (0.5 s, the library default) in float64
    through both packages: every chunk field and y / y_sin / y_nos
    float64 and within 1e-9 of their peak of JAX's; y_sin's SNR >= 45 dB
    and within 0.01 dB of JAX's; no kernel launched; use_pallas refused
    by both option constructors."""
    _run(ROUND_TRIP, "FP64-OK")


def test_fp64_noise_draw_and_kernel_refusal():
    """noise_bins_ref(dtype=float64) equals jax.random.normal's x64 draw
    bit for bit; osc_bank, sample_cycles and noise_bins raise TypeError
    under the knob instead of casting."""
    _run(KNOB, "KNOB-OK")


def test_fp64_card_draw_path_on_the_cpu():
    """The float64 draw as a CUDA device computes it (kernels._log_rn in
    place of libm's log), run on host tensors: the log correctly rounded;
    the normals JAX's x64 draw but at <= 1e-4 of them, each within 2 ulps
    (libm's log, < 0.52 ulp, misrounds where the card's does not)."""
    _run(CARD_DRAW, "CARD-DRAW-OK")
