"""The port's checkpoints and training launcher against the JAX package's,
on the CPU.

Checkpoints: a file written by either package restores in the other bit
for bit, and both write the same ``.paths.json`` (dict keys and list
indices joined by ``/``, leaves in ``jax.tree`` order), on reduced
qwen2-0.5b params and on a tree with lists.  The launcher: ``main(argv)``
of both packages at ``--arch qwen2-0.5b --reduced --steps 3 --batch 4
--seq 32 --scadles --ckpt DIR``, each starting from the same params (the
reference's, with numpy noise on the leaves it makes zero; its
``init_params`` is patched in the launcher's namespace, the port's takes
the converted copy) and each ``make_train_step`` wrapped to record the
batches and metrics it sees.  Tokens, labels and sample weights must be
bit-identical; loss and gradient norm agree to rel 1e-4 and lr is equal;
after 3 Adam steps no param is more than 2 * sum(lr_t) apart (the most two
Adam runs can part: an element whose gradient sits at f32 rounding level
may step +lr on one side and -lr on the other).
"""
import json
import re
import sys
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_pytree as jax_restore  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "qwen2-0.5b"
NOISY = ("'bq'", "'bk'", "'bv'", "'scale'")
ARGV = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "4",
        "--seq", "32", "--scadles"]


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, jax params, port params): reduced qwen2-0.5b."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
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


def _same_bits(ttree, jtree):
    tl, jl = leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                       else b)
        assert a.float().numpy().tobytes() == b.astype(np.float32).tobytes()


def _paths(directory, name):
    with open(directory / f"{name}.paths.json") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# checkpoints


def test_port_checkpoint_restores_in_the_reference(model, tmp_path):
    _, tcfg, jp, tp = model
    save_pytree({"params": tp}, str(tmp_path), name="t")
    back = jax_restore({"params": jp}, str(tmp_path), name="t")
    _same_bits(tp, back["params"])


def test_reference_checkpoint_restores_in_the_port(model, tmp_path):
    _, tcfg, jp, tp = model
    jax_save({"params": jp}, str(tmp_path), name="j")
    template = {"params": init_params(None, tcfg, device="meta")}
    back = restore_pytree(template, str(tmp_path), name="j", device="cpu")
    _same_bits(back["params"], jp)
    assert all(t.device.type == "cpu" for t in leaves(back))


def test_paths_json_equal_between_packages(model, tmp_path):
    """Dict keys, list indices (``SequenceKey`` gives ``"0"``, not
    ``"[0]"``) and leaf order: the same list from both packages, one key a
    leaf."""
    _, _, jp, tp = model
    rng = np.random.default_rng(3)
    extra = {"conv": [{"w": rng.standard_normal((3, 2)).astype(np.float32),
                       "b": np.zeros(2, np.float32)} for _ in range(3)],
             "Z": rng.standard_normal(4).astype(np.float32)}
    jtree = {"params": jp, "extra": jax.tree.map(jnp.asarray, extra)}
    ttree = {"params": tp, "extra": jax.tree.map(torch.from_numpy, extra)}
    save_pytree(ttree, str(tmp_path / "t"))
    jax_save(jtree, str(tmp_path / "j"))
    tpaths, jpaths = _paths(tmp_path / "t", "ckpt"), _paths(tmp_path / "j",
                                                           "ckpt")
    assert tpaths == jpaths
    assert len(tpaths) == len(leaves(ttree)) == len(jax.tree.leaves(jtree))
    assert "extra/conv/2/w" in tpaths and "params/embed" in tpaths
    back = jax_restore(jtree, str(tmp_path / "t"))
    _same_bits(ttree, back)


def test_roundtrip_with_a_bf16_leaf(tmp_path):
    """``tests/test_dist.py::test_checkpoint_roundtrip`` on the port, with
    bf16 values that are not all ones: stored as f32, restored bit for bit
    into a meta template's dtype; the reference restores them too."""
    b = (torch.arange(4, dtype=torch.float32) / 3).to(torch.bfloat16)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": b}}
    save_pytree(tree, str(tmp_path), name="t")
    template = {"a": torch.empty((2, 3), device="meta"),
                "b": {"c": torch.empty((4,), dtype=torch.bfloat16,
                                       device="meta")}}
    out = restore_pytree(template, str(tmp_path), name="t", device="cpu")
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], b)
    stored = np.load(tmp_path / "t.npz")["b/c"]
    assert stored.dtype == np.float32
    jout = jax_restore({"a": jnp.zeros((2, 3)),
                        "b": {"c": jnp.zeros(4, jnp.bfloat16)}},
                       str(tmp_path), name="t")
    assert jout["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jout["b"]["c"], np.float32),
                                  b.float().numpy())


def test_shape_mismatch_raises(tmp_path):
    save_pytree({"w": torch.zeros((2, 3))}, str(tmp_path))
    with pytest.raises(ValueError, match="w: stored shape"):
        restore_pytree({"w": torch.zeros((3, 2))}, str(tmp_path),
                       device="cpu")


# ---------------------------------------------------------------------------
# the launcher


def _recording(make, record, to_host):
    """``make_train_step`` wrapped so each step's batch and metrics are
    recorded (host copies)."""
    def wrapped_make(*args, **kw):
        step = make(*args, **kw)

        def train_step(params, opt_state, batch, i):
            out = step(params, opt_state, batch, i)
            to_host(record, batch, out[2])
            return out

        return train_step

    return wrapped_make


def _jax_to_host(record, batch, metrics):
    # the reference jits the step: record through a host callback
    jax.debug.callback(
        lambda b, m: record.append(
            ({k: np.asarray(v) for k, v in b.items()},
             {k: np.float32(v) for k, v in m.items()})),
        batch, metrics)


def _torch_to_host(record, batch, metrics):
    record.append(({k: v.numpy().copy() for k, v in batch.items()},
                   {k: np.float32(float(v)) for k, v in metrics.items()}))


def _printed(out):
    """(header, [(step, loss, lr text, gnorm)], saved file names)."""
    lines = out.strip().splitlines()
    steps = [(int(m[1]), float(m[2]), m[3], float(m[4])) for m in
             (re.match(r"step\s+(\d+) loss=(\S+) lr=(\S+) gnorm=(\S+) ", ln)
              for ln in lines) if m]
    saved = [ln.split("/")[-1] for ln in lines if ln.startswith("saved ")]
    return lines[0], steps, saved


@pytest.fixture(scope="module")
def launched(model, tmp_path_factory):
    """Both launchers' records, printed output and checkpoint dirs."""
    _, _, jp, tp = model
    tmp = tmp_path_factory.mktemp("launch")
    mp = pytest.MonkeyPatch()
    jrec, trec = [], []
    try:
        mp.setattr(jlaunch, "init_params", lambda key, cfg: jp)
        mp.setattr(jlaunch, "make_train_step",
                   _recording(jlaunch.make_train_step, jrec, _jax_to_host))
        mp.setattr(sys, "argv", ["train"] + ARGV + ["--ckpt", str(tmp / "j")])
        mp.setattr(tlaunch, "init_params", lambda gen, cfg, device: tp)
        mp.setattr(tlaunch, "make_train_step",
                   _recording(tlaunch.make_train_step, trec, _torch_to_host))
        jout, tout = StringIO(), StringIO()
        with redirect_stdout(jout):
            jlaunch.main()
            jax.effects_barrier()
        with redirect_stdout(tout):
            tlaunch.main(ARGV + ["--device", "cpu", "--ckpt", str(tmp / "t")])
    finally:
        mp.undo()
    return dict(jrec=jrec, trec=trec, jout=jout.getvalue(),
                tout=tout.getvalue(), dir=tmp)


def test_launcher_batches_are_bit_identical(launched):
    jrec, trec = launched["jrec"], launched["trec"]
    assert len(jrec) == len(trec) == 3
    for (jb, _), (tb, _) in zip(jrec, trec):
        assert set(tb) == set(jb) == {"tokens", "labels", "sample_weights"}
        for key in tb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])
    # the weights follow the streaming rates: not uniform, sum to 1
    w = trec[0][0]["sample_weights"]
    assert np.ptp(w) > 0 and abs(float(w.sum()) - 1) < 1e-6


def test_launcher_metrics_and_lines_match_reference(launched):
    """Loss and gradient norm to rel 1e-4, lr equal; the printed lines:
    the same header and steps, each printed number within one unit of its
    last printed digit; the lr at step 0 is 0."""
    for (_, jm), (_, tm) in zip(launched["jrec"], launched["trec"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4)
        assert tm["lr"] == jm["lr"]
    assert launched["trec"][0][1]["lr"] == 0
    jhead, jsteps, jsaved = _printed(launched["jout"])
    thead, tsteps, tsaved = _printed(launched["tout"])
    assert thead == jhead == "arch=qwen2-0.5b-reduced params=1.4M devices=1"
    assert [s[0] for s in tsteps] == [s[0] for s in jsteps] == [0, 2]
    for (_, tl, tlr, tg), (_, jl, jlr, jg) in zip(tsteps, jsteps):
        assert tlr == jlr
        assert abs(tl - jl) <= 1e-4 + 1e-4 * abs(jl)
        assert abs(tg - jg) <= 1e-3 + 1e-4 * abs(jg)
    assert tsaved == jsaved == ["qwen2-0.5b-reduced.npz"]


def test_launcher_checkpoints_restore_across_packages(launched, model):
    """Each launcher's checkpoint restores bit for bit in the other
    package; the two runs' final params lie within 2 * sum(lr_t)."""
    _, tcfg, jp, _ = model
    d, name = launched["dir"], "qwen2-0.5b-reduced"
    assert _paths(d / "t", name) == _paths(d / "j", name)
    template = {"params": init_params(None, tcfg, device="meta")}
    jtemplate = {"params": jp}
    t_final = restore_pytree(template, str(d / "t"), name=name, device="cpu")
    _same_bits(t_final, jax_restore(jtemplate, str(d / "t"), name=name))
    j_final = jax_restore(jtemplate, str(d / "j"), name=name)
    _same_bits(restore_pytree(template, str(d / "j"), name=name,
                              device="cpu"), j_final)
    lr_sum = sum(float(m["lr"]) for _, m in launched["trec"])
    gap = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
              for a, b in zip(leaves(t_final), jax.tree.leaves(j_final)))
    assert 0 < lr_sum and gap <= 2 * lr_sum
