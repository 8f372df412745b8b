"""The port's xLSTM family against the JAX package, on the CPU.

Reduced xlstm-125m: an mLSTM and an sLSTM layer (4 heads of 64, d 256, no
FFN, tied embeddings).  The reference's params, with numpy noise on the
leaves it makes zero or constant (norm scales; the gate biases ``bi``,
``bf`` and ``b_in``), are carried across by ``params_from_jax``; inputs are
drawn from numpy seeds.  The reference runs its jax paths
(``kernel_interpret=False``); the xLSTM blocks have no kernel in either
package.

Covered: ``mlstm_chunked`` at chunks 16, 32 and 64, its state handoff and
the sequential oracle; ``mlstm_decode_step``; ``slstm_block`` and its
decode step; the training forward, loss and ``make_loss_fn``'s gradient;
``decode_step`` step by step; ``prefill_cache`` with 256 dividing the
prompt and not; ``ChunkedPrefill`` against the reference and against one
shot; slot insert/evict (fixed and paged) of the mLSTM and sLSTM states;
paged against fixed-slot decode; a reference cache carried across by
``cache_from_jax``; the runner behind the scheduler; the launcher.

Tolerances are ``tests/test_torch_zoo.py``'s: logits 1e-4 (decode 2e-4,
the reference's decode bound), caches 1e-5, hidden states 1e-5, gradients
2e-5 + 1e-3 relative; the xLSTM mixers alone 1e-5.  The states add 1e-5
relative (``STATE_RTOL``) to the caches' 1e-5: an sLSTM ``c`` or ``n`` is
an unnormalised sum that grows with the sequence (to ~3 after 20 tokens),
so its f32 rounding grows with it (the worst seen: 1.5e-5 at 3.3, 4.5e-6
relative).  The chunked form against the sequential oracle keeps the
reference's own 5e-4 (``tests/test_attention.py``): they sum the decays in
different orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.train.step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.transformer import (RunCtx, forward_hidden,  # noqa: E402
                                            lm_loss)
from repro_torch.train.step import make_loss_fn  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCH = "xlstm-125m"
JCTX = jtf.RunCtx(remat=False, chunk_q=8, chunk_k=8, loss_chunk=8,
                  kernel_interpret=False)
TCTX = RunCtx(remat=False, loss_chunk=8, device="cpu")
NOISY = ("'scale'", "'bi'", "'bf'", "'b_in'")
DECODE_TOL = 2e-4
MIXER_TOL = 1e-5
STATE_RTOL = 1e-5
ORACLE_TOL = 5e-4


def _noise(tree, seed=0):
    rng = np.random.default_rng(seed)

    def f(path, a):
        if any(n in jax.tree_util.keystr(path) for n in NOISY):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def model():
    """(jcfg, jax params, tcfg, port params)."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _noise(jax.tree.map(np.asarray,
                               jtf.init_params(jax.random.PRNGKey(1), jcfg)))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, device="cpu"))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _x(cfg, b, s, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model))).astype(np.float32)


def _close(t, j, atol, msg="", rtol=0.0):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def _close_cache(tc, jc, atol):
    for part in ("unit", "rest"):
        assert set(tc[part]) == set(jc[part])
        for layer, cl in jc[part].items():
            assert set(tc[part][layer]) == set(cl)
            for name, a in cl.items():
                _close(tc[part][layer][name], a, atol,
                       f"{part}.{layer}.{name}", rtol=STATE_RTOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _mixer(model, kind):
    """The first layer of ``kind``'s params in both packages (layer 0 is
    the mLSTM, layer 1 the sLSTM; each is its own stack unit)."""
    jcfg, jp, tcfg, tp = model
    j = 0 if kind == "mlstm" else 1
    return (jcfg, jax.tree.map(lambda a: a[0], jp["unit"][f"p{j}"][kind]),
            tcfg, {k: v[0] for k, v in tp["unit"][f"p{j}"][kind].items()})


# ---------------------------------------------------------------------------
# the mixers


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mlstm_chunked_matches_jax(model, chunk):
    """Against the reference at the same chunk (1e-5, state too), and
    against the port's own sequential oracle at the reference's 5e-4."""
    jcfg, jp, tcfg, tp = _mixer(model, "mlstm")
    x = _x(tcfg, 2, 64, seed=1)
    jy, jst = jx.mlstm_chunked(jp, jnp.asarray(x), jcfg, chunk=chunk,
                               return_state=True)
    ty, tst = tx.mlstm_chunked(tp, torch.from_numpy(x), tcfg, chunk=chunk,
                               return_state=True)
    _close(ty, jy, MIXER_TOL)
    for a, b in zip(tst, jst):
        _close(a, b, MIXER_TOL)
    seq, sst = tx.mlstm_sequential(tp, torch.from_numpy(x), tcfg)
    _close(ty, seq.numpy(), ORACLE_TOL)
    _close(tst.c, sst.c.numpy(), ORACLE_TOL)


def test_mlstm_state_handoff(model):
    """Two chunked runs with the state carried between them equal one run
    (the reference's check), and the reference's carried run."""
    jcfg, jp, tcfg, tp = _mixer(model, "mlstm")
    x = torch.from_numpy(_x(tcfg, 1, 64, seed=2))
    full = tx.mlstm_chunked(tp, x, tcfg, chunk=16)
    y1, st = tx.mlstm_chunked(tp, x[:, :32], tcfg, chunk=16,
                              return_state=True)
    y2 = tx.mlstm_chunked(tp, x[:, 32:], tcfg, state=st, chunk=16)
    _close(torch.cat([y1, y2], 1), full.numpy(), ORACLE_TOL)
    j1, jst = jx.mlstm_chunked(jp, jnp.asarray(x[:, :32].numpy()), jcfg,
                               chunk=16, return_state=True)
    j2 = jx.mlstm_chunked(jp, jnp.asarray(x[:, 32:].numpy()), jcfg,
                          state=jst, chunk=16)
    _close(y2, j2, MIXER_TOL)
    with pytest.raises(ValueError, match="multiple"):
        tx.mlstm_chunked(tp, x[:, :24], tcfg, chunk=16)


def test_mlstm_sequential_and_decode_step_match_jax(model):
    """The sequential oracle from the fresh state, then one decode step from
    a carried one: outputs and states within 1e-5."""
    jcfg, jp, tcfg, tp = _mixer(model, "mlstm")
    x = _x(tcfg, 2, 12, seed=3)
    jy, jst = jx.mlstm_sequential(jp, jnp.asarray(x), jcfg)
    ty, tst = tx.mlstm_sequential(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy, MIXER_TOL)
    step = _x(tcfg, 2, 1, seed=4)
    jy, jst = jx.mlstm_decode_step(jp, jnp.asarray(step), jcfg, jst)
    ty, tst = tx.mlstm_decode_step(tp, torch.from_numpy(step), tcfg, tst)
    _close(ty, jy, MIXER_TOL)
    for a, b in zip(tst, jst):
        _close(a, b, MIXER_TOL)


def test_slstm_block_and_decode_step_match_jax(model):
    """``slstm_block`` over 24 steps (output and state), the same block from
    a carried state, and a decode step, each against the reference
    (1e-5); the block equals its own decode steps."""
    jcfg, jp, tcfg, tp = _mixer(model, "slstm")
    x = _x(tcfg, 2, 24, seed=5)
    jy, jst = jx.slstm_block(jp, jnp.asarray(x[:, :16]), jcfg,
                             return_state=True)
    ty, tst = tx.slstm_block(tp, torch.from_numpy(x[:, :16]), tcfg,
                             return_state=True)
    _close(ty, jy, MIXER_TOL)
    for a, b in zip(tst, jst):
        _close(a, b, MIXER_TOL)
    jy2 = jx.slstm_block(jp, jnp.asarray(x[:, 16:]), jcfg, state=jst)
    ty2 = tx.slstm_block(tp, torch.from_numpy(x[:, 16:]), tcfg, state=tst)
    _close(ty2, jy2, MIXER_TOL)
    st, ys = tst, []
    for t in range(16, 24):
        y, st = tx.slstm_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                     tcfg, st)
        ys.append(y)
    _close(torch.cat(ys, 1), ty2.numpy(), MIXER_TOL)
    jy, _ = jx.slstm_decode_step(jp, jnp.asarray(x[:, 16:17]), jcfg, jst)
    _close(ys[0], jy, MIXER_TOL)


def test_mlstm_grad_is_finite_through_the_masked_gap(model):
    """The ``-inf`` fill of the causal gap and the ``-1e30`` start of the
    stabiliser give exact zeros and no NaN in autograd; the gradient of
    the chunked form matches the reference's ``jax.grad``."""
    jcfg, jp, tcfg, tp = _mixer(model, "mlstm")
    x = _x(tcfg, 1, 32, seed=6)
    jg = jax.grad(lambda p: jnp.sum(jx.mlstm_chunked(
        p, jnp.asarray(x), jcfg, chunk=16) ** 2))(jp)
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    torch.sum(tx.mlstm_chunked(live, torch.from_numpy(x), tcfg,
                               chunk=16) ** 2).backward()
    for k, v in live.items():
        assert bool(torch.isfinite(v.grad).all()), k
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]),
                                   atol=2e-5, rtol=1e-3, err_msg=k)


# ---------------------------------------------------------------------------
# the model: training forward, loss, gradient


def test_forward_loss_and_grad_match_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(tcfg, 2, 16)
    labels = np.roll(toks, -1, axis=1)
    jh, _ = jtf.forward_hidden(jp, jnp.asarray(toks), jcfg, JCTX)
    th, taux = forward_hidden(tp, torch.from_numpy(toks).long(), tcfg, TCTX)
    _close(th, jh, 1e-5)
    assert float(taux) == 0
    jl = jtf.lm_loss(jp, jh, jnp.asarray(labels), jcfg, JCTX)
    tl = lm_loss(tp, th, torch.from_numpy(labels).long(), tcfg, TCTX)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    (jt, _), jg = jax.value_and_grad(jax_make_loss_fn(jcfg, JCTX),
                                     has_aux=True)(jp, jb)
    live = [p.clone().requires_grad_() for p in leaves(tp)]
    tt, _ = make_loss_fn(tcfg, dataclasses.replace(TCTX, remat=True))(
        unflatten(tp, live), tb)
    tt.backward()
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
    for p, g in zip(live, jax.tree.leaves(jg)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=1e-3)


# ---------------------------------------------------------------------------
# serving


def test_decode_steps_match_jax(model):
    """20 tokens one step at a time from empty caches in both packages:
    every step's logits within 2e-4; the states after the last step within
    1e-5."""
    jcfg, jp, tcfg, tp = model
    b, s = 2, 20
    toks = _tokens(tcfg, b, s, seed=1)
    jc = jdec.init_cache(jcfg, b, s, JCTX)
    tc = tdec.init_cache(tcfg, b, s, TCTX)
    _close_cache(tc, jc, 0.0)
    step = jax.jit(lambda c, t: jdec.decode_step(jp, c, t, jcfg, JCTX))
    for t in range(s):
        jl, jc = step(jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]).long(), tcfg, TCTX)
        _close(tl, jl, DECODE_TOL, f"step {t}")
    _close_cache(tc, jc, 1e-5)


@pytest.mark.parametrize("s", [20, 300, 512])
def test_prefill_cache_matches_jax(model, s):
    """Fused prefill, then 3 decode steps: logits within 1e-4, states within
    1e-5.  The mLSTM chunk is min(256, s), or s where 256 does not divide
    it: one chunk of 20, one of 300, two of 256."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(tcfg, 1, s, seed=3)
    jl, jc = jdec.prefill_cache(jp, jnp.asarray(toks),
                                jdec.init_cache(jcfg, 1, s + 4, JCTX), jcfg,
                                JCTX)
    tl, tc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                tdec.init_cache(tcfg, 1, s + 4, TCTX), tcfg,
                                TCTX)
    _close(tl, jl, 1e-4)
    _close_cache(tc, jc, 1e-5)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdec.decode_step(jp, jc, jnp.asarray(nxt), jcfg, JCTX)
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                                  tcfg, TCTX)
        _close(tl, jl, 1e-4, f"step {i}")
    _close_cache(tc, jc, 1e-5)


def test_chunked_prefill_matches_jax_and_one_shot(model):
    """13 tokens in chunks of 4 (4+4+4+1; each mLSTM step one chunk of its
    own length): against the reference's chunked prefill (logits 1e-4,
    states 1e-5) and the port's one-shot prefill (1e-5)."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(tcfg, 1, 13, seed=4)
    jcp = jdec.ChunkedPrefill(jp, jnp.asarray(toks),
                              jdec.init_cache(jcfg, 1, 16, JCTX), jcfg, JCTX)
    tcp = tdec.ChunkedPrefill(tp, torch.from_numpy(toks).long(),
                              tdec.init_cache(tcfg, 1, 16, TCTX), tcfg, TCTX)
    while not tcp.done:
        assert tcp.step(4) == jcp.step(4)
    jl, jc = jcp.finish()
    tl, tc = tcp.finish()
    _close(tl, jl, 1e-4)
    _close_cache(tc, jc, 1e-5)
    wl, wc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                tdec.init_cache(tcfg, 1, 16, TCTX), tcfg,
                                TCTX)
    _close(tl, wl.numpy(), 1e-5)
    for a, b in zip(leaves(tc), leaves(wc)):
        _close(a, b.numpy(), 1e-5)


def _prefilled(tp, tcfg, plen, cache_len, seed):
    toks = torch.from_numpy(_tokens(tcfg, 1, plen, seed=seed)).long()
    one = tdec.init_cache(tcfg, 1, cache_len, TCTX)
    one["pos"] = torch.zeros((1,), dtype=torch.int32)
    return tdec.prefill_cache(tp, toks, one, tcfg, TCTX)[1]


STATES = {"p0": ("c", "n", "m"), "p1": ("c", "n", "h", "m")}


@pytest.mark.parametrize("entry", ["slot", "paged"])
def test_slot_insert_evict_carry_xlstm_state(model, entry):
    """mLSTM and sLSTM states go into a slot bit for bit, through
    ``slot_insert``/``slot_evict`` of a fixed-slot cache or
    ``paged_insert``/``paged_evict`` of a paged one (which holds them
    slot-resident: the stack has no page to map), leave the other slots
    alone, and eviction zeroes them."""
    _, _, tcfg, tp = model
    cache_len = 32
    if entry == "paged":
        cache = tdec.init_paged_cache(tcfg, 3, cache_len, TCTX, page_size=8,
                                      num_pages=4)
        assert tdec.pages_needed(tcfg, cache_len, 8, 20) == 0
        insert, evict = tdec.paged_insert, tdec.paged_evict
    else:
        cache = tdec.init_slot_cache(tcfg, 3, cache_len, TCTX)
        insert, evict = tdec.slot_insert, tdec.slot_evict
    srcs = [_prefilled(tp, tcfg, plen, cache_len, seed=10 + i)
            for i, plen in enumerate((5, 11, 7))]
    for slot, src in enumerate(srcs):
        if entry == "paged":
            insert(cache, slot, src, [])
        else:
            insert(cache, slot, src)
    for layer, names in STATES.items():
        for name in names:
            for slot, src in enumerate(srcs):
                assert torch.equal(cache["unit"][layer][name][:, slot],
                                   src["unit"][layer][name][:, 0])
            assert bool(src["unit"][layer][name].abs().max() > 0)
    assert cache["pos"].tolist() == [5, 11, 7]
    evict(cache, 1)
    for layer, names in STATES.items():
        for name in names:
            assert not bool(cache["unit"][layer][name][:, 1].any())
            for slot in (0, 2):
                assert torch.equal(cache["unit"][layer][name][:, slot],
                                   srcs[slot]["unit"][layer][name][:, 0])
    assert cache["pos"].tolist() == [5, 0, 7]


def test_paged_decode_bit_identical_to_fixed(model):
    """A paged and a fixed-slot cache at one occupancy decode the same
    logits bit for bit through inserts, steps and an eviction."""
    _, _, tcfg, tp = model
    fixed = tdec.init_slot_cache(tcfg, 4, 32, TCTX)
    paged = tdec.init_paged_cache(tcfg, 4, 32, TCTX, page_size=8,
                                  num_pages=8)
    for slot, plen in enumerate((5, 11, 3)):
        src = _prefilled(tp, tcfg, plen, 32, 20 + slot)
        tdec.slot_insert(fixed, slot, src)
        tdec.slot_insert(paged, slot, src, pages=[])
    tok = torch.tensor([[3], [7], [1], [0]])
    live = [0, 1, 2]
    for i in range(6):
        lf, _ = tdec.decode_step(tp, fixed, tok, tcfg, TCTX)
        lp, _ = tdec.decode_step(tp, paged, tok, tcfg, TCTX)
        assert torch.equal(lf[live], lp[live]), f"step {i}"
        if i == 2:
            tdec.slot_evict(fixed, 1)
            tdec.slot_evict(paged, 1)
            src = _prefilled(tp, tcfg, 9, 32, 30)
            tdec.slot_insert(fixed, 3, src)
            tdec.slot_insert(paged, 3, src, pages=[])
            live = [0, 2, 3]


def test_cache_from_jax_decodes_like_jax(model):
    """A reference slot cache with two prefilled slots, carried across by
    ``cache_from_jax``, decodes one step to the reference's logits (1e-4)
    and states (1e-5)."""
    jcfg, jp, tcfg, tp = model
    jc = jdec.init_slot_cache(jcfg, 2, 32, JCTX)
    for slot, plen in enumerate((6, 13)):
        toks = jnp.asarray(_tokens(tcfg, 1, plen, seed=40 + slot))
        _, src = jdec.prefill_cache(jp, toks, jdec.init_cache(jcfg, 1, 32,
                                                              JCTX),
                                    jcfg, JCTX)
        jc = jdec.slot_insert(jc, slot, src)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    tok = np.array([[2], [5]], np.int32)
    jl, jc = jdec.decode_step(jp, jc, jnp.asarray(tok), jcfg, JCTX)
    tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(tok).long(), tcfg,
                              TCTX)
    _close(tl, jl, 1e-4)
    _close_cache(tc, jc, 1e-5)


def test_real_runner_tokens_identical(model):
    """A Table I trace through the scheduler with chunked prefill (chunks
    of 8): the port's fixed-slot and paged runners generate the same greedy
    tokens as each other and as the reference's runner fed the same
    prompts; no prefix sharing for this family."""
    jcfg, jp, tcfg, tp = model

    def run(pkg, params, cfg, ctx, prompts=None, **kw):
        runner = pkg.SlotRunner(params, cfg, ctx, 2, 40, **kw)
        if prompts is not None:
            runner.prompt_tokens = prompts
        trace = pkg.RequestStream(dist="S1", n_clients=4, prompt_lens=(8, 20),
                                  max_new_tokens=6, slo_ttft_s=2.0,
                                  slo_tpot_s=0.5, seed=0).generate(2.0)
        cost = pkg.StepCostModel(decode_step_s=0.01, prefill_token_s=5e-4,
                                 prefill_base_s=1e-3)
        _, s = pkg.Scheduler(2, cost, runners=[runner],
                             chunk_tokens=8).run(trace, horizon_s=2.0)
        assert s["conservation_ok"]
        return runner

    fixed = run(tserve, tp, tcfg, TCTX)
    paged = run(tserve, tp, tcfg, TCTX, page_size=8, num_pages=4,
                prefix_sharing=True)
    assert paged.prefix_index is None
    ref = run(jserve, jp, jcfg, JCTX, prompts=lambda req: jnp.asarray(
        fixed.prompt_tokens(req).numpy().astype(np.int32)))
    assert len(fixed.generated) > 2
    assert paged.generated == fixed.generated
    assert ref.generated == fixed.generated


def test_offline_launcher_serves_on_cpu():
    args = launch.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16", "--gen",
                              "4", "--temperature", "0"])
    res = launch.run_offline(args)
    assert res["tokens"].shape == (2, 4)
    assert res["audio_feats"] is None
    cfg, ctx, params, prompts, _ = launch.setup(args)
    cache = tdec.init_cache(cfg, 2, 20, ctx)
    logits, cache = tdec.prefill_cache(params, prompts, cache, cfg, ctx)
    for i in range(4):
        nxt = torch.argmax(logits, -1)
        assert torch.equal(nxt, res["tokens"][:, i])
        logits, cache = tdec.decode_step(params, cache, nxt[:, None], cfg,
                                         ctx)
    assert torch.equal(logits, res["last_logits"])


def test_full_size_f32_spread_against_the_reference():
    """xlstm-125m at full width and depth (random weights, b 8 x 128, 16
    greedy steps) in both packages on the CPU: two correct f32
    implementations whose logits differ by ~7e-4 after prefill and ~9e-4
    after the steps (where the reduced model agrees to 1e-4).  The mLSTM
    divides by max(|q.n|, exp(-m)), which random weights put near
    cancellation for some (token, head), so the model amplifies rounding
    about 3 000-fold.  This is the spread ``chip_smoke.py``'s XLSTM_TOL
    (1e-2) is set against; the greedy tokens agree here."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, tcfg, device="cpu")
    del tree
    b, s, gen = 8, 128, 16
    toks = _tokens(tcfg, b, s)
    # params as jit arguments: captured, they become constants that take
    # XLA far longer to compile
    jl, jc = jax.jit(lambda p, c, t: jdec.prefill_cache(p, t, c, jcfg,
                                                        JCTX))(
        jp, jdec.init_cache(jcfg, b, s + gen, JCTX), jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                    tdec.init_cache(tcfg, b, s + gen, TCTX),
                                    tcfg, TCTX)
        errs = [float(np.abs(np.asarray(jl) - tl.numpy()).max())]
        step = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, jcfg, JCTX))
        for _ in range(gen):
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            assert np.array_equal(nxt[:, 0], tl.argmax(-1).numpy())
            jl, jc = step(jp, jc, jnp.asarray(nxt))
            tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                                      tcfg, TCTX)
        errs.append(float(np.abs(np.asarray(jl) - tl.numpy()).max()))
    print(f"xlstm-125m f32 spread, reference vs port: prefill {errs[0]:.3e},"
          f" after {gen} steps {errs[1]:.3e}")
    assert 1e-4 < max(errs) < 1e-2
