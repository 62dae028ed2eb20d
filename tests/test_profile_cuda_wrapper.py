"""CPU tests of what surrounds the CUDA profile-DP kernel: the choice of
implementation by platform, the FFI call's shapes, padding, channel
packing and the base-count gather.  The kernel itself runs only on a GPU
(tests/test_chip.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from csa_jax.align import progressive
from csa_jax.config import Scoring
from csa_jax.dp import profile_cuda, wavefront


def _item(rng, R, C, i=5):
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
    return codes, sv, i, progressive.default_top_row(sv, i), -i


@pytest.mark.parametrize("platform,want", [("gpu", "cuda"), ("cpu", "rowscan"),
                                           ("tpu", "rowscan")])
def test_device_dp_chosen_by_platform(monkeypatch, platform, want):
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(profile_cuda, "profile_path",
                        lambda *a, **k: calls.append("cuda") or "cuda")
    monkeypatch.setattr(profile_cuda, "profile_paths",
                        lambda *a, **k: calls.append("cuda") or "cuda")
    monkeypatch.setattr(wavefront, "dp_path_rowscan",
                        lambda *a, **k: calls.append("rowscan") or "rowscan")
    monkeypatch.setattr(wavefront, "dp_paths_rowscan_batched",
                        lambda *a, **k: calls.append("rowscan") or "rowscan")
    item = _item(np.random.default_rng(0), 20, 30)
    assert wavefront.dp_path_device(*item) == want
    assert wavefront.dp_paths_device_batched([item, item]) == want
    assert calls == [want, want]


def test_ffi_call_shapes(monkeypatch):
    """The CUDA route traces to one FFI call with the layout's shapes."""
    monkeypatch.setattr(profile_cuda, "_register", lambda: None)
    rng = np.random.default_rng(1)
    items = [_item(rng, 600, 700), _item(rng, 100, 40)]
    codes, sv, top, iv, erg, rr, cc, Rp, Cp, Gp = wavefront._pad_batch(items)
    assert (Gp, Rp, Cp) == (8, 1024, 1024)
    args = [jnp.asarray(x) for x in (codes, sv, iv, top, erg, rr, cc)]
    jaxpr = jax.make_jaxpr(
        lambda *a: profile_cuda._paths_core(*a, sc=Scoring(), impl="cuda")
    )(*args)
    eqns = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "ffi_call"]
    assert len(eqns) == 1
    assert eqns[0].params["target_name"] == profile_cuda.TARGET
    shapes = [(tuple(v.aval.shape), v.aval.dtype) for v in eqns[0].outvars]
    ns = Cp // profile_cuda.STRIP
    assert shapes == [
        ((Gp, Rp + Cp), jnp.int8),
        ((Gp,), jnp.int32),
        ((Gp, ns, Rp + 32, 32), jnp.uint16),
        ((Gp * ns, Rp + 1), jnp.int32),
        ((Gp * ns + 1,), jnp.int32),
    ]
    assert [tuple(v.aval.shape) for v in jaxpr.jaxpr.outvars] == [
        (Gp, Rp + Cp), (Gp,)]


def test_pad_batch_buckets():
    rng = np.random.default_rng(2)
    one = [_item(rng, 513, 100)]
    *_, Rp, Cp, Gp = wavefront._pad_batch(one, min_g=1)
    assert (Gp, Rp, Cp) == (1, 1024, 512)
    *_, Gp = wavefront._pad_batch(one * 9)
    assert Gp == 16
    *_, Gp = wavefront._pad_batch(one * 9, g_multiple=3)
    assert Gp == 18
    big = [_item(rng, 8193, 9000)]
    *_, Rp, Cp, _ = wavefront._pad_batch(big, min_g=1)
    assert (Rp, Cp) == (10240, 10240)
    assert Cp % profile_cuda.STRIP == 0


def test_channels_pack_counts_and_priorities():
    rng = np.random.default_rng(3)
    sc = Scoring(match=3, mismatch=-2, indel=-4, doublegap=-1)
    G, C = 2, 16
    sv = rng.integers(0, 65, size=(G, C, 5)).astype(np.int8)
    iv = np.array([64, 7], np.int32)
    top = rng.integers(-99, 9, size=(G, C + 1)).astype(np.int32)
    erg = np.array([-3, -5], np.int32)
    rr = np.array([10, 11], np.int32)
    cc = np.array([C, C - 1], np.int32)
    codes = np.zeros((G, 4), np.int8)
    _, svpack, rest4, cg4, top4, scal = (np.asarray(x) for x in
        profile_cuda._channels(*(jnp.asarray(x) for x in
                                 (codes, sv, iv, top, erg, rr, cc)), sc=sc))
    sv64 = sv.astype(np.int64)
    for b in range(4):
        np.testing.assert_array_equal((svpack >> (7 * b)) & 127, sv64[..., b])
    assert ((svpack >> 28) & 127 == 0).all()  # the pad code reads 0
    i = iv[:, None].astype(np.int64)
    svg = sv64[..., 4]
    np.testing.assert_array_equal(
        rest4, 4 * ((sc.indel - sc.mismatch) * svg + sc.mismatch * i) + 2)
    np.testing.assert_array_equal(
        cg4, 4 * (sc.doublegap * svg + sc.indel * (i - svg)) + 1)
    np.testing.assert_array_equal(top4, 4 * top)
    np.testing.assert_array_equal(
        scal, np.stack([4 * sc.indel * iv, 4 * erg, rr, cc], axis=1))


def test_base_counts_gather_equals_one_hot():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, size=50).astype(np.int8)  # 4 = pad
    sv = rng.integers(0, 65, size=(70, 5)).astype(np.int32)
    want = np.asarray(jax.nn.one_hot(codes, 4, dtype=jnp.int32)) @ sv[:, :4].T
    got = np.asarray(wavefront._base_counts(jnp.asarray(codes),
                                            jnp.asarray(sv)))
    np.testing.assert_array_equal(got, want)
