"""The port's ``make_train_step`` against the JAX package's, on the CPU.

Reduced configs (2 layers, d <= 512, vocab 1024): the reference's params,
with numpy noise on the leaves it makes zero (QKV biases, norm scales), are
carried across by ``params_from_jax``; tokens, labels, ScaDLES sample
weights, qwen2-vl's patch embeddings and M-RoPE positions come from numpy
seeds.  One step of momentum SGD (momentum 0.9, lr 1e-2) from zero
momentum.  Bars, as ``tests/test_torch_train.py`` states them for the same
f32 programs: loss rel 1e-6, ``grad_norm`` rel 1e-5 (a norm over every
leaf, summed in another order), params 1e-6 abs (lr times gradients that
agree to 2e-5), momentum 3e-5 abs + 1e-3 rel (it is the gradient itself);
microbatched against whole-batch at the reference's own 2e-4 rel + 2e-5
abs (``tests/test_models_smoke.py``).  The smoke cases of
``tests/test_models_smoke.py`` run on the port for every assigned arch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import RunCtx, init_params, param_count_tree  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import (MOE_AUX_WEIGHT, make_loss_fn,  # noqa: E402
                                    split_microbatches)
from repro_torch.tree import leaves  # noqa: E402

JCTX = jtf.RunCtx(remat=False, chunk_q=16, chunk_k=16, loss_chunk=16,
                  kernel_interpret=False)
TCTX = RunCtx(remat=False, loss_chunk=16, device="cpu")
LR, MOMENTUM = 1e-2, 0.9
NOISY = ("'bq'", "'bk'", "'bv'", "'scale'")


def _model(arch):
    """(jcfg, tcfg, jax params, port params) of a reduced config."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(0)

    def noise(path, a):
        if any(n in jax.tree_util.keystr(path) for n in NOISY):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(noise, tree)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen2-0.5b")


def _batch(cfg, b=4, s=32, seed=0, vlm=False):
    """The same batch as jax arrays and as tensors; non-uniform sample
    weights that sum to 1."""
    rng = np.random.default_rng(seed)
    w = rng.random(b).astype(np.float32) + 0.5
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s), np.int32),
             "sample_weights": (w / w.sum()).astype(np.float32)}
    if vlm:
        # patches on a 4 x 4 grid, then text numbered on from the grid
        npk, side = cfg.num_patch_tokens, 4
        batch["patch_embeds"] = (0.5 * rng.standard_normal(
            (b, npk, cfg.d_model))).astype(np.float32)
        pos = np.zeros((3, b, s), np.int32)
        pos[1, :, :npk] = np.arange(npk) // side
        pos[2, :, :npk] = np.arange(npk) % side
        for row in range(b):
            pos[:, row, npk:] = side + 3 * row + np.arange(s - npk)
        batch["mrope_positions"] = pos
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _jax_step(jcfg, jp, jb, **kw):
    init, upd = jopt.make_optimizer("sgdm", momentum=MOMENTUM)
    step = jax.jit(jax_make_train_step(jcfg, JCTX, upd, lambda t: LR, **kw))
    return step(jp, init(jp), jb, jnp.asarray(0))


def _port_step(tcfg, tp, tb, ctx=TCTX, **kw):
    init, upd = topt.make_optimizer("sgdm", momentum=MOMENTUM)
    return make_train_step(tcfg, ctx, upd, lambda t: LR, **kw)(
        tp, init(tp), tb, 0)


def _max_err(ttree, jtree):
    tl, jl = leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    return max(float(np.max(np.abs(a.float().numpy()
                                   - np.asarray(b, np.float32))))
               for a, b in zip(tl, jl))


def _assert_close(ttree, jtree, **tol):
    tl, jl = leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **tol)


def _assert_step_matches(t_out, j_out):
    (tp, ts, tm), (jp, js, jm) = t_out, j_out
    for key in ("loss", "total"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert np.float32(tm["lr"]) == np.float32(jm["lr"]) == np.float32(LR)
    _assert_close(tp, jp, atol=1e-6, rtol=0)
    _assert_close(ts["mom"], js["mom"], atol=3e-5, rtol=1e-3)


def _port_trees_close(a, b, **tol):
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **tol)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(qwen, n_micro):
    """One step of each package from the same params and batch: the
    mean-form gradient (n_micro 1) and two sum-form microbatches."""
    jcfg, tcfg, jp, tp = qwen
    jb, tb = _batch(tcfg, seed=1)
    t_out = _port_step(tcfg, tp, tb, n_micro=n_micro)
    _assert_step_matches(t_out, _jax_step(jcfg, jp, jb, n_micro=n_micro))
    assert set(t_out[2]) == {"loss", "aux", "total", "grad_norm", "lr"}
    if n_micro > 1:
        assert float(t_out[2]["aux"]) == 0.0
        assert float(t_out[2]["loss"]) == float(t_out[2]["total"])
    # no graph survives the step
    assert not any(p.requires_grad for p in leaves(t_out[0]))
    assert not any(m.requires_grad for m in leaves(t_out[1]["mom"]))


def test_microbatched_step_matches_whole_batch(qwen):
    """The port alone: two microbatches against the whole batch at the
    reference's bar (``tests/test_models_smoke.py``)."""
    _, tcfg, _, tp = qwen
    _, tb = _batch(tcfg, seed=2)
    p1, _, m1 = _port_step(tcfg, tp, tb)
    p2, _, m2 = _port_step(tcfg, tp, tb, n_micro=2)
    _port_trees_close(p2, p1, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(m2["total"]), float(m1["total"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=2e-4)


def test_bf16_wire_matches_jax(qwen):
    """Each microbatch gradient rounded to bf16 before the f32 add.  The
    two packages' f32 gradients differ by ~1e-6 relative, so an element
    near a bf16 rounding edge may round one way in one package and the
    other way in the other: the bar is one bf16 ulp of the largest
    gradient, lr * 2^-8 * max|g| on the params (2^-8 * max|g| on the
    momentum, which is the accumulated gradient), max|g| from the f32 wire
    run.  The bf16 run must differ from the f32 one."""
    jcfg, tcfg, jp, tp = qwen
    jb, tb = _batch(tcfg, seed=3)
    t_out = _port_step(tcfg, tp, tb, n_micro=2, grad_wire_bf16=True)
    j_out = _jax_step(jcfg, jp, jb, n_micro=2, grad_wire_bf16=True)
    f32_p, f32_s, _ = _port_step(tcfg, tp, tb, n_micro=2)
    g_max = max(float(m.abs().max()) for m in leaves(f32_s["mom"]))
    ulp = 2.0 ** -8 * g_max
    assert _max_err(t_out[0], j_out[0]) <= LR * ulp
    assert _max_err(t_out[1]["mom"], j_out[1]["mom"]) <= ulp
    np.testing.assert_allclose(float(t_out[2]["total"]),
                               float(j_out[2]["total"]), rtol=1e-6)
    np.testing.assert_allclose(float(t_out[2]["grad_norm"]),
                               float(j_out[2]["grad_norm"]), rtol=1e-4)
    assert max(float((a - b).abs().max()) for a, b in
               zip(leaves(t_out[0]), leaves(f32_p))) > 0


def test_vlm_mrope_positions_split_over_microbatches():
    """qwen2-vl with patch embeddings and (3, b, s) M-RoPE positions: the
    positions split on their batch axis, as the reference splits them;
    the port against the reference at n_micro 2, and against its own
    whole-batch step."""
    jcfg, tcfg, jp, tp = _model("qwen2-vl-2b")
    jb, tb = _batch(tcfg, seed=4, vlm=True)
    micro = split_microbatches(tb["mrope_positions"], 2)
    assert micro.shape == (2, 3, 2, 32)
    assert torch.equal(micro[1], tb["mrope_positions"][:, 2:])
    t_out = _port_step(tcfg, tp, tb, n_micro=2)
    _assert_step_matches(t_out, _jax_step(jcfg, jp, jb, n_micro=2))
    p1, _, _ = _port_step(tcfg, tp, tb)
    _port_trees_close(t_out[0], p1, rtol=2e-4, atol=2e-5)


def test_three_row_batch_splits_along_the_sequence(qwen):
    """Reference behaviour kept: with a global batch of exactly 3 rows,
    ``x.ndim >= 2 and x.shape[0] == 3`` takes tokens and labels for M-RoPE
    positions, so they split along the sequence while the (3,) weights
    split by row; microbatch i is every row's i-th third of the sequence
    under weight w_i alone.  Both packages agree, and the port's total is
    that sum, not the whole-batch loss."""
    jcfg, tcfg, jp, tp = qwen
    jb, tb = _batch(tcfg, b=3, s=24, seed=5)
    assert split_microbatches(tb["tokens"], 3).shape == (3, 3, 8)
    assert split_microbatches(tb["sample_weights"], 3).shape == (3, 1)
    t_out = _port_step(tcfg, tp, tb, n_micro=3)
    _assert_step_matches(t_out, _jax_step(jcfg, jp, jb, n_micro=3))
    loss_sum = make_loss_fn(tcfg, TCTX, sum_form=True)
    with torch.no_grad():
        by_hand = sum(float(loss_sum(tp, {
            "tokens": tb["tokens"][:, 8 * i:8 * i + 8],
            "labels": tb["labels"][:, 8 * i:8 * i + 8],
            "sample_weights": tb["sample_weights"][i:i + 1]})[0])
            for i in range(3))
    np.testing.assert_allclose(float(t_out[2]["total"]), by_hand, rtol=1e-6)
    _, _, whole = _port_step(tcfg, tp, tb, ctx=RunCtx(
        remat=False, loss_chunk=8, device="cpu"))
    assert abs(float(whole["total"]) - by_hand) > 1e-3


def test_moe_total_carries_the_aux_loss():
    """Mixtral (reduced, top-2 of 4 experts): ``total`` is the loss plus
    MOE_AUX_WEIGHT times the load-balance loss, in both packages."""
    jcfg, tcfg, jp, tp = _model("mixtral-8x22b")
    jb, tb = _batch(tcfg, seed=6)
    t_out = _port_step(tcfg, tp, tb)
    j_out = _jax_step(jcfg, jp, jb)
    tm, jm = t_out[2], j_out[2]
    assert float(tm["aux"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-6)
    np.testing.assert_allclose(
        float(tm["total"]), float(tm["loss"]) + MOE_AUX_WEIGHT
        * float(tm["aux"]), rtol=1e-6)
    _assert_step_matches(t_out, j_out)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_count_tree_matches_jax(arch):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    shapes = jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    want = jtf.param_count_tree(shapes)
    assert param_count_tree(init_params(None, tcfg, device="meta")) == want


def _smoke_batch(cfg, b=2, s=32):
    """``tests/test_models_smoke.py``'s batch, drawn with numpy."""
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                           np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "audio":
        batch["audio_feats"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32))
        batch["mrope_positions"] = torch.arange(s).expand(3, b, s)
    return batch


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_reduced_train_step_on_the_port(arch):
    """The reference's smoke case (``tests/test_models_smoke.py::
    test_reduced_train_step``) on the port: finite loss and gradient norm,
    params moved, the second step's loss below 1.05 times the first's."""
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    init, upd = topt.make_optimizer("sgdm", momentum=MOMENTUM)
    step = make_train_step(cfg, TCTX, upd, lambda t: LR)
    batch = _smoke_batch(cfg)
    p1, o1, m1 = step(params, init(params), batch, 0)
    assert np.isfinite(float(m1["loss"]))
    assert np.isfinite(float(m1["grad_norm"])) and float(m1["grad_norm"]) > 0
    delta = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(leaves(p1), leaves(params)))
    assert delta > 0
    _, _, m2 = step(p1, o1, batch, 1)
    assert float(m2["loss"]) < float(m1["loss"]) * 1.05


def test_refusals(qwen):
    """Microbatching needs sample weights; ``grad_shardings`` must mirror
    the params."""
    _, tcfg, _, tp = qwen
    _, tb = _batch(tcfg)
    weights = tb.pop("sample_weights")
    with pytest.raises(ValueError, match="sample weights"):
        _port_step(tcfg, tp, tb, n_micro=2)
    tb["sample_weights"] = weights
    with pytest.raises(ValueError, match="grad_shardings"):
        _port_step(tcfg, tp, tb, n_micro=2, grad_shardings={})


def test_grad_shardings_on_one_rank_give_the_unsharded_bits(qwen, tmp_path):
    """On a one-rank gloo group, the (1, 1) mesh's step (params, momentum
    and batch placed by ``distribute``, the ZeRO-2 accumulator pinned by
    ``grad_shardings``) equals the single-device step bit for bit at
    ``n_micro`` 2: on one rank every collective is the identity."""
    import torch.distributed as dist
    from repro_torch.dist import (batch_specs, distribute, make_plan,
                                  make_run_ctx, named, param_specs)
    from repro_torch.launch.mesh import make_test_mesh
    _, tcfg, _, tp = qwen
    _, tb = _batch(tcfg)
    p1, s1, m1 = _port_step(tcfg, tp, tb, n_micro=2)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), device="cpu")
        plan = make_plan(mesh)
        ctx = make_run_ctx(tcfg, plan, compute_dtype=torch.float32,
                           param_dtype=torch.float32, remat=False,
                           chunk_q=TCTX.chunk_q, chunk_k=TCTX.chunk_k,
                           loss_chunk=TCTX.loss_chunk, device="cpu")
        specs = param_specs(tp, tcfg, plan)
        init, upd = topt.make_optimizer("sgdm", momentum=MOMENTUM)
        step = make_train_step(tcfg, ctx, upd, lambda t: LR, n_micro=2,
                               grad_shardings=named(tp, specs, mesh))
        pd = distribute(tp, specs, mesh)
        p2, s2, m2 = step(pd, init(pd), distribute(
            tb, batch_specs(tcfg, plan, tb), mesh), 0)
        for a, b in zip(leaves(p2) + leaves(s2), leaves(p1) + leaves(s1)):
            assert torch.equal(a.full_tensor(), b)
        for k in ("loss", "grad_norm"):
            assert torch.equal(m2[k].full_tensor(), m1[k])
    finally:
        dist.destroy_process_group()
