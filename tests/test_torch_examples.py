"""The five ``examples/*_torch.py`` against the originals, on the CPU.

Each counterpart's ``main(argv)`` runs with ``--device cpu`` and each
original's ``main()`` with ``sys.argv`` set, both at a few steps, stdout
captured.  Both start from the reference's initial parameters, carried over
with ``params_from_jax`` (``init_params`` patched in each module, or the
edge MLP's ``init``); ``serve_batched`` runs both on the same fixed cost
model (the original times its device), and ``fleet_churn`` at a small
``STEPS`` in both modules.

The printed lines must come in the same order with the same text between
the numbers.  Integer and sim-clock fields must be identical.  Losses,
gradient norms and accuracies may differ by one unit of their last printed
digit plus 1e-4 relative (the trainer and launcher tests' bar); the
launcher's wall-clock s/it is not compared.
"""
import importlib.util
import re
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
# a number is loose (a loss, gradient norm or accuracy) when the text before
# it ends with one of these
LOOSE_AFTER = ("loss", "loss=", "gnorm=", "acc=", "acc", "scadles=", "ddl=",
               "(drop", "done:", "->")
FLEET_ROW = re.compile(r"^\s*\d+\s+\d+\.\d\s+")     # step, sim_t, loss, ...


def _load(name):
    """``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a: str, b: str) -> bool:
    decimals = len(b.split(".")[1]) if "." in b else 0
    return abs(float(a) - float(b)) <= 10.0 ** -decimals + 1e-4 * abs(
        float(b))


def _compare(tout: str, jout: str) -> int:
    """Hold the port's printed lines against the original's; returns how
    many numbers were held loosely."""
    tl, jl = tout.strip().splitlines(), jout.strip().splitlines()
    assert len(tl) == len(jl), (tl, jl)
    loose = 0
    for t, j in zip(tl, jl):
        assert NUM.split(t) == NUM.split(j), (t, j)
        skel = NUM.split(j)
        for i, (a, b) in enumerate(zip(NUM.findall(t), NUM.findall(j))):
            if skel[i + 1].startswith("s/it"):
                continue                        # wall clock
            if (skel[i].strip().endswith(LOOSE_AFTER)
                    or (FLEET_ROW.match(j) and i == 2)):
                assert _close(a, b), (t, j)
                loose += 1
            else:
                assert a == b, (t, j)
    return loose


def _run(fn, *args):
    out = StringIO()
    with redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _lm_params(arch):
    jcfg = jax_get_config(arch).reduced()
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(1), jcfg))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, get_config(arch).reduced(), device="cpu"))


def _mlp_models(jex, tex):
    """Model factories for both modules whose ``init`` returns the
    reference's edge-MLP params (fresh copies on the port's side)."""
    jmodel = jex["make"]()
    jp = jmodel["init"](jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}

    def jmake():
        return dict(jex["make"](), init=lambda key: jp)

    def tmake():
        return dict(tex["make"](),
                    init=lambda gen, device: {k: v.clone().to(device)
                                              for k, v in tp.items()})

    return jmake, tmake


def test_quickstart_matches_original(monkeypatch):
    jq, tq = _load("quickstart"), _load("quickstart_torch")
    jp, tp = _lm_params("qwen2-0.5b")
    monkeypatch.setattr(jq, "init_params", lambda key, cfg: jp)
    monkeypatch.setattr(tq, "init_params", lambda gen, cfg, device: tp)
    monkeypatch.setattr(sys, "argv", ["quickstart", "--steps", "6"])
    jout = _run(jq.main)
    tout = _run(tq.main, ["--steps", "6", "--device", "cpu"])
    assert tout.splitlines()[0] == "qwen2-0.5b-reduced: 1.4M params"
    assert _compare(tout, jout) == 4          # steps 0 and 5, done's two


def test_train_e2e_matches_original(monkeypatch, tmp_path):
    je, te = _load("train_e2e"), _load("train_e2e_torch")
    jp, tp = _lm_params("xlstm-125m")
    monkeypatch.setattr(jlaunch, "init_params", lambda key, cfg: jp)
    monkeypatch.setattr(tlaunch, "init_params", lambda gen, cfg, device: tp)
    outs = {}
    for side, run in (("j", lambda: je.main()),
                      ("t", lambda: te.main(["--steps", "3", "--device",
                                             "cpu"]))):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        monkeypatch.setattr(sys, "argv", ["train_e2e", "--steps", "3"])
        outs[side] = _run(run)
        if side == "j":
            jax.effects_barrier()
        assert (tmp_path / side / "artifacts" / "ckpt"
                / "xlstm-125m-reduced.npz").exists()
    assert outs["t"].splitlines()[-1] == \
        "saved artifacts/ckpt/xlstm-125m-reduced.npz"
    assert _compare(outs["t"], outs["j"]) == 4    # loss, gnorm at steps 0, 2


def test_serve_batched_matches_original(monkeypatch):
    js, ts = _load("serve_batched"), _load("serve_batched_torch")
    jp, tp = _lm_params("recurrentgemma-2b")
    cost = dict(decode_step_s=0.02, prefill_token_s=2e-4,
                prefill_base_s=2e-3)
    # the reference's serving decode takes its jax path here: its Pallas
    # kernels do not run under this jax (ROADMAP.md, ground rules)
    monkeypatch.setenv(jengine.DECODE_BACKEND_ENV, "jax")
    monkeypatch.setattr(js, "init_params", lambda key, cfg: jp)
    monkeypatch.setattr(ts, "init_params", lambda gen, cfg, device: tp)
    monkeypatch.setattr(js, "measured_cost_model",
                        lambda *a, **k: jengine.StepCostModel(**cost))
    monkeypatch.setattr(ts, "measured_cost_model",
                        lambda *a, **k: tengine.StepCostModel(**cost))
    monkeypatch.setattr(sys, "argv", ["serve_batched", "--gen", "8"])
    jout = _run(js.main)
    tout = _run(ts.main, ["--gen", "8", "--device", "cpu"])
    assert _compare(tout, jout) == 0
    summary = dict(line.split(" = ") for line in tout.splitlines())
    assert int(summary["completed"]) == int(summary["n_requests"]) > 0


@pytest.mark.parametrize("extra", [[], ["--skew", "dirichlet"]],
                         ids=["iid", "dirichlet"])
def test_scadles_streaming_matches_original(monkeypatch, extra):
    js, ts = _load("scadles_streaming"), _load("scadles_streaming_torch")
    jmake, tmake = _mlp_models({"make": js.make_mlp}, {"make": ts.make_mlp})
    monkeypatch.setattr(js, "make_mlp", jmake)
    monkeypatch.setattr(ts, "make_mlp", tmake)
    argv = ["--steps", "4"] + extra
    monkeypatch.setattr(sys, "argv", ["scadles_streaming"] + argv)
    jout = _run(js.main)
    tout = _run(ts.main, argv + ["--device", "cpu"])
    assert _compare(tout, jout) == 3           # the accuracy line


def test_fleet_churn_matches_original(monkeypatch):
    jf, tf = _load("fleet_churn"), _load("fleet_churn_torch")
    jmake, tmake = _mlp_models({"make": jf.make_model},
                               {"make": tf.make_model})
    monkeypatch.setattr(jf, "make_model", jmake)
    monkeypatch.setattr(tf, "make_model", tmake)
    for mod in (jf, tf):
        monkeypatch.setattr(mod, "STEPS", 2)
    monkeypatch.setattr(sys, "argv", ["fleet_churn"])
    jout = _run(jf.main)
    tout = _run(tf.main, ["--device", "cpu"])
    assert "== timeline (full-sync) ==" in tout
    # 2 timeline losses, 5 policy accuracies, 5 speedup accuracies, 8
    # switch-run losses, the controller's accuracy
    assert _compare(tout, jout) == 21
