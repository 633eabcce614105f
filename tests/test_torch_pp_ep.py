"""The PyTorch port's pipeline- and expert-parallel training
(parallel/pipeline.py, parallel/expert.py) on ranks of torch.distributed
(gloo, the CPU): tests/test_pp_ep.py's five cases, and parity with the
JAX package on its own initial weights carried across (params_from_jax).

Two worlds (2 and 4 ranks, torch.multiprocessing.spawn, FileStore
rendezvous) run the sharded cases once each and save their results; the
JAX side runs here in the parent (jax is imported only inside the
fixture and the test functions, so the ranks never import it)."""
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from libllsm2_tpu_torch.models import neural as tnn
from libllsm2_tpu_torch.parallel import distributed as tdist
from libllsm2_tpu_torch.parallel import expert as tex
from libllsm2_tpu_torch.parallel import mesh as tmesh
from libllsm2_tpu_torch.parallel import pipeline as tpp

torch.set_num_threads(1)

PP_FWD = tpp.TrunkConfig(dims=20, hidden=32, n_blocks=8, n_micro=4)
PP_TRAIN = tpp.TrunkConfig(dims=12, hidden=16, n_blocks=4, n_micro=4,
                           lr=3e-3)
EP_FWD = tex.MoEConfig(dims=20, hidden=32, n_experts=8)
EP_TRAIN = tex.MoEConfig(dims=16, hidden=32, n_experts=8, lr=3e-3)


def _toy_batch(n, dims, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((n, dims)), dtype=torch.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _params(r):
    return {k: p.detach().numpy().copy() for k, p in r.named_parameters()}


def _rank(r, n, d):
    """The sharded cases of a world of n ranks -> {d}/rank{r}.pkl."""
    torch.set_num_threads(1)
    tdist.initialize_multihost(f"file://{d}/store", n, r, timeout_s=300)
    out = {}
    pm = tmesh.make_pipe_mesh(n, device="cpu")
    em = tmesh.make_expert_mesh(n, device="cpu")
    # pipeline forward
    params = tpp.init_trunk_params(PP_FWD, _gen(0), device="cpu")
    x = _toy_batch(16, PP_FWD.dims)
    out["pp_fwd"] = tpp.pp_forward(PP_FWD, tpp.shard_params_pp(params, pm),
                                   x, pm).detach().numpy()
    # expert forward (no token dropped: capacity 64 / n)
    params = tex.init_moe_params(EP_FWD, _gen(2), device="cpu")
    x = _toy_batch(64, EP_FWD.dims, seed=2)
    y, aux = tex.moe_forward_ep(EP_FWD, tex.shard_params_ep(EP_FWD, params,
                                                            em),
                                tmesh.shard_rows(x, em, tmesh.EXPERT_AXIS),
                                em, capacity=64 // n)
    out["ep_fwd"] = (tmesh.all_gather(y.detach(), em,
                                      tmesh.EXPERT_AXIS).numpy(), float(aux))
    if n == 4:
        # pipeline training, 5 steps
        ps = tpp.shard_params_pp(
            tpp.init_trunk_params(PP_TRAIN, _gen(1), device="cpu"), pm)
        opt = tpp.make_optimizer(PP_TRAIN, ps)
        x = _toy_batch(32, PP_TRAIN.dims, seed=1)
        losses = []
        for _ in range(5):
            ps, opt, loss = tpp.train_step_pp(PP_TRAIN, ps, opt, x, pm)
            losses.append(float(loss))
        out["pp_train"] = (losses, tuple(ps.blocks_w.shape))
        # expert training, 40 steps
        es = tex.shard_params_ep(
            EP_TRAIN, tex.init_moe_params(EP_TRAIN, _gen(4), device="cpu"),
            em)
        opt = tex.make_optimizer(EP_TRAIN, es)
        x = tmesh.shard_rows(_toy_batch(128, EP_TRAIN.dims, seed=4), em,
                             tmesh.EXPERT_AXIS)
        losses = []
        for _ in range(40):
            es, opt, loss = tex.train_step_ep(EP_TRAIN, es, opt, x, em)
            losses.append(float(loss))
        out["ep_train"] = (losses, tuple(es.experts_w.shape))
        # the JAX package's weights: forward and one training step
        with open(f"{d}/jax_params.pkl", "rb") as f:
            jp = pickle.load(f)
        ps = tpp.shard_params_pp(tpp.params_from_jax(PP_TRAIN, jp["pp"],
                                                     device="cpu"), pm)
        x = _toy_batch(32, PP_TRAIN.dims, seed=1)
        fwd = tpp.pp_forward(PP_TRAIN, ps, x, pm).detach().numpy()
        opt = tpp.make_optimizer(PP_TRAIN, ps)
        ps, opt, loss = tpp.train_step_pp(PP_TRAIN, ps, opt, x, pm)
        out["pp_jax"] = (fwd, float(loss), _params(ps))
        es = tex.shard_params_ep(EP_TRAIN, tex.params_from_jax(
            EP_TRAIN, jp["ep"], device="cpu"), em)
        x = tmesh.shard_rows(_toy_batch(128, EP_TRAIN.dims, seed=4), em,
                             tmesh.EXPERT_AXIS)
        y, _ = tex.moe_forward_ep(EP_TRAIN, es, x, em)
        fwd = tmesh.all_gather(y.detach(), em, tmesh.EXPERT_AXIS).numpy()
        opt = tex.make_optimizer(EP_TRAIN, es)
        es, opt, loss = tex.train_step_ep(EP_TRAIN, es, opt, x, em)
        out["ep_jax"] = (fwd, float(loss), _params(es))
    with open(f"{d}/rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _jax_params():
    import jax

    from libllsm2_tpu.parallel import expert as jex
    from libllsm2_tpu.parallel import pipeline as jpp
    leaves = lambda t: jax.tree.map(np.asarray, t)
    return {"pp": leaves(jpp.init_trunk_params(
                jpp.TrunkConfig(dims=12, hidden=16, n_blocks=4, n_micro=4,
                                lr=3e-3), jax.random.PRNGKey(1))),
            "ep": leaves(jex.init_moe_params(
                jex.MoEConfig(dims=16, hidden=32, n_experts=8, lr=3e-3),
                jax.random.PRNGKey(4)))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in (2, 4):
        d = str(tmp_path_factory.mktemp(f"world{n}"))
        if n == 4:
            with open(f"{d}/jax_params.pkl", "wb") as f:
                pickle.dump(_jax_params(), f)
        mp.spawn(_rank, args=(n, d), nprocs=n)
        out[n] = []
        for r in range(n):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                out[n].append(pickle.load(f))
    return out


# ---------------------------------------------------------------- pipeline

def test_pipeline_forward_matches_reference(worlds):
    params = tpp.init_trunk_params(PP_FWD, _gen(0), device="cpu")
    ref = tpp.forward_reference(PP_FWD, params,
                                _toy_batch(16, PP_FWD.dims)).detach().numpy()
    for n, ranks in worlds.items():
        for o in ranks:
            np.testing.assert_allclose(o["pp_fwd"], ref, rtol=2e-5,
                                       atol=2e-5)


def test_pipeline_train_matches_unsharded(worlds):
    """5-step pipeline-parallel losses == a one-process AdamW run on the
    same trunk (the gradient flows back through the ppermute pipeline);
    each stage holds its blocks only."""
    params = tpp.init_trunk_params(PP_TRAIN, _gen(1), device="cpu")
    opt = tpp.make_optimizer(PP_TRAIN, params)
    x = _toy_batch(32, PP_TRAIN.dims, seed=1)
    ref = [float(tnn.optimizer_step(opt, lambda: torch.mean(
        (tpp.forward_reference(PP_TRAIN, params, x) - x) ** 2)).detach())
        for _ in range(5)]
    for o in worlds[4]:
        losses, shape = o["pp_train"]
        np.testing.assert_allclose(losses, ref, rtol=1e-4)
        assert shape == (PP_TRAIN.n_blocks // 4, 16, 16)


# ------------------------------------------------------------------ expert

def test_moe_ep_forward_matches_dense_reference(worlds):
    """With capacity large enough that nothing drops, the all_to_all
    expert-parallel forward equals the dense one-process evaluation of the
    same top-1 routing."""
    params = tex.init_moe_params(EP_FWD, _gen(2), device="cpu")
    ref = tex.moe_forward_reference(
        EP_FWD, params, _toy_batch(64, EP_FWD.dims, seed=2),
        capacity=64).detach().numpy()
    for n, ranks in worlds.items():
        for o in ranks:
            got, aux = o["ep_fwd"]
            np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
            assert np.isfinite(aux) and aux > 0.5


def test_moe_capacity_overflow_passes_residual():
    """Tokens beyond an expert's capacity fall through the residual
    identity (their MoE contribution exactly zero)."""
    cfg = tex.MoEConfig(dims=8, hidden=16, n_experts=2)
    params = tex.init_moe_params(cfg, _gen(3), device="cpu")
    x = _toy_batch(32, cfg.dims, seed=3)
    with torch.no_grad():
        full = tex.moe_forward_reference(cfg, params, x, capacity=32)
        tight = tex.moe_forward_reference(cfg, params, x, capacity=1)
        h = tnn.gelu(tnn.dense(params.entry, x, cfg.compute_dtype))
        resid = tnn.dense(params.exit, h, cfg.compute_dtype)
        disp, _, _, _ = tex._route(cfg, params.gate, h, 1)
    kept = (disp.sum(dim=(1, 2)) > 0.5).numpy()
    assert kept.sum() == cfg.n_experts
    np.testing.assert_allclose(tight[~kept], resid[~kept], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tight[kept], full[kept], rtol=1e-5, atol=1e-6)


def test_moe_ep_training_reduces_loss(worlds):
    for o in worlds[4]:
        losses, shape = o["ep_train"]
        assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
        assert shape == (EP_TRAIN.n_experts // 4, 32, 32)
    assert len({tuple(o["ep_train"][0]) for o in worlds[4]}) == 1


# ------------------------------------------------------- the JAX package's

def test_pipeline_matches_jax(worlds):
    """The JAX package's init_trunk_params through params_from_jax: the
    4-stage forward within 2e-5 of JAX's forward_reference, and one
    training step's loss and every stage's parameters against JAX's
    train_step_pp on a 4-device pipe mesh."""
    import jax.numpy as jnp

    from libllsm2_tpu.parallel import mesh as jmesh
    from libllsm2_tpu.parallel import pipeline as jpp
    cfg = jpp.TrunkConfig(dims=12, hidden=16, n_blocks=4, n_micro=4,
                          lr=3e-3)
    import jax
    p0 = jpp.init_trunk_params(cfg, jax.random.PRNGKey(1))
    x = jnp.asarray(_toy_batch(32, 12, seed=1).numpy())
    ref = np.asarray(jpp.forward_reference(cfg, p0, x))
    m = jmesh.make_pipe_mesh(4)
    ps = jpp.shard_params_pp(p0, m)
    p1, _, loss = jpp.train_step_pp(cfg, ps, jpp.make_optimizer(cfg).init(ps),
                                    x, m)
    bw, bb = np.asarray(p1["blocks"]["w"]), np.asarray(p1["blocks"]["b"])
    for s, o in enumerate(worlds[4]):
        fwd, l_t, params = o["pp_jax"]
        np.testing.assert_allclose(fwd, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(l_t, float(loss), rtol=1e-5)
        tol = dict(rtol=1e-4, atol=1e-6)
        for name in ("entry", "exit"):
            np.testing.assert_allclose(params[f"{name}.weight"],
                                       np.asarray(p1[name]["w"]).T, **tol)
            np.testing.assert_allclose(params[f"{name}.bias"],
                                       np.asarray(p1[name]["b"]), **tol)
        np.testing.assert_allclose(params["blocks_w"],
                                   bw[s:s + 1].transpose(0, 2, 1), **tol)
        np.testing.assert_allclose(params["blocks_b"], bb[s:s + 1], **tol)


def test_expert_matches_jax(worlds):
    """The JAX package's init_moe_params through params_from_jax: the
    expert-parallel forward within 2e-5 of JAX's moe_forward_ep, and one
    training step's loss and parameters against JAX's train_step_ep on a
    4-device expert mesh."""
    import jax
    import jax.numpy as jnp

    from libllsm2_tpu.parallel import expert as jex
    from libllsm2_tpu.parallel import mesh as jmesh
    cfg = jex.MoEConfig(dims=16, hidden=32, n_experts=8, lr=3e-3)
    p0 = jex.init_moe_params(cfg, jax.random.PRNGKey(4))
    m = jmesh.make_expert_mesh(4)
    ps = jex.shard_params_ep(cfg, p0, m)
    x = jax.device_put(jnp.asarray(_toy_batch(128, 16, seed=4).numpy()),
                       jax.NamedSharding(m, jax.sharding.PartitionSpec(
                           "expert")))
    ref, _ = jex.moe_forward_ep(cfg, ps, x, m)
    p1, _, loss = jex.train_step_ep(cfg, ps, jex.make_optimizer(cfg).init(ps),
                                    x, m)
    k = cfg.n_experts // 4
    for s, o in enumerate(worlds[4]):
        fwd, l_t, params = o["ep_jax"]
        np.testing.assert_allclose(fwd, np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(l_t, float(loss), rtol=1e-5)
        tol = dict(rtol=1e-4, atol=1e-6)
        for name in ("entry", "exit"):
            np.testing.assert_allclose(params[f"{name}.weight"],
                                       np.asarray(p1[name]["w"]).T, **tol)
            np.testing.assert_allclose(params[f"{name}.bias"],
                                       np.asarray(p1[name]["b"]), **tol)
        np.testing.assert_allclose(params["gate"], np.asarray(p1["gate"]),
                                   **tol)
        np.testing.assert_allclose(
            params["experts_w"], np.asarray(p1["experts"]["w"])
            [s * k:(s + 1) * k].transpose(0, 2, 1), **tol)
        np.testing.assert_allclose(
            params["experts_b"], np.asarray(p1["experts"]["b"])
            [s * k:(s + 1) * k], **tol)
