"""The port's kernel modules against the JAX package's pure-JAX paths.

On the CPU each wrapper runs its plain version (the CUDA kernels run only on
the card, where ``chip_smoke.py`` holds them against these plain versions).
Inputs are made with numpy from a seed and handed to both packages.  The
JAX side is the reference's pure-JAX path (``chunked_attention`` /
``decode_attention`` with ``backend="jax"``), never its Pallas kernels.
Tolerances are the reference's own oracle tests': 2e-5 f32 / 2e-2 bf16 for
prefill attention (tests/test_kernels_flash.py), 2e-6 for decode
(tests/test_kernels_decode.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro.models.attention import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.models.attention import (chunked_attention,  # noqa: E402
                                          decode_attention)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(shape, seed, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(out_t, ref_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(ref_j, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash_attention (prefill)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [1, 2, 4])
@pytest.mark.parametrize("kind", ["causal", "swa", "bidir"])
def test_flash_attention_matches_jax(kind, kvh, dtype):
    b, s, h, hd, window = 2, 128, 4, 32, 48
    qj, qt = _both((b, s, h, hd), 1, dtype)
    kj, kt = _both((b, s, kvh, hd), 2, dtype)
    vj, vt = _both((b, s, kvh, hd), 3, dtype)
    ref = jax_chunked(qj, kj, vj, kind=kind, window=window, chunk_q=64,
                      chunk_k=64)
    out = fa.flash_attention(qt, kt, vt, kind=kind, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, 2e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("kind,window", [("causal", 0), ("swa", 12)])
def test_flash_attention_q_offset(kind, window):
    """Chunked prefill: the last queries attend against a longer key range
    from a static offset."""
    b, sq, sk, h, kvh, hd, off = 2, 24, 40, 4, 2, 64, 16
    qj, qt = _both((b, sq, h, hd), 4)
    kj, kt = _both((b, sk, kvh, hd), 5)
    vj, vt = _both((b, sk, kvh, hd), 6)
    ref = jax_chunked(qj, kj, vj, kind=kind, window=window, q_offset=off)
    out = fa.flash_attention(qt, kt, vt, kind=kind, window=window,
                             q_offset=off)
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("kind", ["causal", "swa", "bidir"])
def test_flash_attention_ragged_lengths(kind):
    """Lengths that no tile divides: the kernel's tiles leave a ragged
    edge; the reference's chunks snap to divisors of 100."""
    b, s, h, kvh, hd = 1, 100, 4, 2, 64
    qj, qt = _both((b, s, h, hd), 7)
    kj, kt = _both((b, s, kvh, hd), 8)
    vj, vt = _both((b, s, kvh, hd), 9)
    ref = jax_chunked(qj, kj, vj, kind=kind, window=30)
    out = fa.flash_attention_ref(qt, kt, vt, kind=kind, window=30)
    _close(out, ref, 2e-5)


# ---------------------------------------------------------------------------
# flash_decode


@pytest.mark.parametrize("kv_len", [[1, 24, 13, 7], [0, 30, 5, 24]])
def test_flash_decode_mixed_age(kv_len):
    """Per-slot kv_len on a fixed-slot cache of mixed-age rows, including
    the minimum, the full length, and the out-of-range 0 and S+6."""
    b, S, h, kvh, hd = 4, 24, 4, 2, 8
    qj, qt = _both((b, 1, h, hd), 10)
    kj, kt = _both((b, S, kvh, hd), 11)
    vj, vt = _both((b, S, kvh, hd), 12)
    ref = jax_decode(qj, kj, vj, jnp.asarray(kv_len, jnp.int32))
    out = fd.flash_decode(qt, kt, vt, torch.tensor(kv_len, dtype=torch.int32))
    _close(out, ref, 2e-6)


def test_flash_decode_scalar_len():
    """Scalar kv_len (lockstep batch) and an S that no tile divides."""
    b, S, h, kvh, hd = 2, 37, 14, 2, 64
    qj, qt = _both((b, 1, h, hd), 13)
    kj, kt = _both((b, S, kvh, hd), 14)
    vj, vt = _both((b, S, kvh, hd), 15)
    ref = jax_decode(qj, kj, vj, 29)
    out = fd.flash_decode(qt, kt, vt, torch.tensor(29, dtype=torch.int32))
    _close(out, ref, 2e-6)


def test_flash_decode_ring_storage_order_irrelevant():
    """A wrapped SWA ring stores tokens rotated; rotating K/V rows must not
    change the output, and both orders match the reference."""
    b, S, h, kvh, hd = 2, 16, 2, 2, 8
    qj, qt = _both((b, 1, h, hd), 16)
    kj, kt = _both((b, S, kvh, hd), 17)
    vj, vt = _both((b, S, kvh, hd), 18)
    ref = jax_decode(qj, kj, vj, S)
    out = fd.flash_decode(qt, kt, vt, S)
    out_r = fd.flash_decode(qt, torch.roll(kt, 5, dims=1),
                            torch.roll(vt, 5, dims=1), S)
    _close(out, ref, 2e-6)
    _close(out_r, ref, 2e-6)


def test_flash_decode_bf16():
    """bf16 caches: the plain version casts p to bf16 before PV, as the
    reference does."""
    b, S, h, kvh, hd = 3, 40, 4, 1, 32
    qj, qt = _both((b, 1, h, hd), 19, "bfloat16")
    kj, kt = _both((b, S, kvh, hd), 20, "bfloat16")
    vj, vt = _both((b, S, kvh, hd), 21, "bfloat16")
    lens = [40, 3, 17]
    ref = jax_decode(qj, kj, vj, jnp.asarray(lens, jnp.int32))
    out = fd.flash_decode(qt, kt, vt, torch.tensor(lens, dtype=torch.int32))
    assert out.dtype == torch.bfloat16
    _close(out, ref, 2e-2)


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_decode_group_16(hd):
    """g = 16 query heads per kv head, the kernel's MAX_GROUP edge, with
    kv_len of 0, 1, a mid value and past S."""
    b, S, h, kvh = 4, 70, 32 if hd == 64 else 16, 2 if hd == 64 else 1
    assert h // kvh == fd.MAX_GROUP
    qj, qt = _both((b, 1, h, hd), 25)
    kj, kt = _both((b, S, kvh, hd), 26)
    vj, vt = _both((b, S, kvh, hd), 27)
    lens = [0, 1, 33, S + 6]
    ref = jax_decode(qj, kj, vj, jnp.asarray(lens, jnp.int32))
    out = fd.flash_decode(qt, kt, vt, torch.tensor(lens, dtype=torch.int32))
    _close(out, ref, 2e-6)


def test_check_aligned_refuses_a_view_off_by_one_element():
    """The kernel copies K/V rows in 16-byte pieces: the wrapper's check
    raises on a contiguous view that starts one element into its buffer,
    and passes the buffer itself."""
    buf = torch.zeros(2 * 16 * 2 * 64 + 1)
    whole = buf[:-1].view(2, 16, 2, 64)
    shifted = buf[1:].view(2, 16, 2, 64)
    assert shifted.is_contiguous()
    fd.check_aligned(k_cache=whole)
    with pytest.raises(ValueError, match="16-byte"):
        fd.check_aligned(k_cache=shifted)
    with pytest.raises(ValueError, match="v_pool"):
        fd.check_aligned(q=whole, v_pool=shifted)


# ---------------------------------------------------------------------------
# dispatch: on CPU tensors the kernel backend is the plain version


def test_cpu_kernel_backend_is_plain_and_launches_nothing():
    b, s, h, kvh, hd = 2, 20, 4, 2, 32
    _, q = _both((b, s, h, hd), 22)
    _, k = _both((b, s, kvh, hd), 23)
    _, v = _both((b, s, kvh, hd), 24)
    before = (fa.launches, fd.launches)
    out_k = chunked_attention(q, k, v, kind="swa", window=6, backend="kernel")
    out_t = chunked_attention(q, k, v, kind="swa", window=6, backend="torch")
    torch.testing.assert_close(out_k, out_t, rtol=1e-6, atol=1e-6)
    lens = torch.tensor([3, 20], dtype=torch.int32)
    dec_k = decode_attention(q[:, :1], k, v, lens, backend="kernel")
    dec_t = decode_attention(q[:, :1], k, v, lens, backend="torch")
    assert torch.equal(dec_k, dec_t)
    assert (fa.launches, fd.launches) == before


@pytest.mark.parametrize("fn", ["chunked", "decode"])
def test_unknown_backend_raises(fn):
    _, q = _both((1, 4, 2, 32), 25)
    with pytest.raises(ValueError, match="backend"):
        if fn == "chunked":
            chunked_attention(q, q, q, backend="pallas")
        else:
            decode_attention(q[:, :1], q, q, 4, backend="jax")


# ---------------------------------------------------------------------------
# what the wrappers check and pass to the card (pure host logic)


def test_kv_len_vector_passes_per_slot_lengths_through():
    """A decode step hands the wrapper its (b,) int32 lengths: no copy."""
    lens = torch.tensor([3, 20, 7], dtype=torch.int32)
    out = fd._kv_len_vector(lens, 3, lens.device)
    assert out.data_ptr() == lens.data_ptr()
    assert fd._kv_len_vector(5, 3, "cpu").tolist() == [5, 5, 5]


@pytest.mark.parametrize("bad", ["head_dim", "float16", "mixed", "layout"])
def test_check_launch_rejects(bad):
    from repro_torch.kernels._common import check_launch
    q = torch.zeros((2, 4, 4, 64))
    k = torch.zeros((2, 4, 2, 64))
    if bad == "head_dim":
        q, k = q[..., :48].contiguous(), k[..., :48].contiguous()
    elif bad == "float16":
        q, k = q.half(), k.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    else:
        k = k.transpose(1, 2)
    check_launch(torch.zeros((2, 4, 4, 64)), torch.zeros((2, 4, 2, 64)))
    with pytest.raises((ValueError, TypeError)):
        check_launch(q, k)


def test_lib_path_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header rebuilds every kernel that includes it."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.lib_path("k")
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _build.lib_path("k") != before
