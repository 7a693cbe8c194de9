"""The fast-path plan built without O(rows) host arrays, and the native
planner (myfm_tpu_torch/design_categorical.py ``_plan_tiles`` /
``_derive_src_slot_device``, myfm_tpu_torch/_native): the counts-only
metadata equals the TPU package's, the torch derivation of the src /
slot layouts equals the TPU package's jitted derivation and the host
pack bit for bit (masked rows and row-less entities included), and the
native planner's three passes equal the port's numpy loops and the TPU
package's results.  A planner that does not build raises with the
compiler's log."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from myfm_tpu import design as jdesign
from myfm_tpu import design_categorical as jdc
from myfm_tpu_torch import _native, tracing
from myfm_tpu_torch import design as tdesign
from myfm_tpu_torch import design_categorical as tdc


def _entities(seed, masked, N=650, B=23):
    rng = np.random.RandomState(seed)
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6  # an entity with no rows
    ent[: N // 5] = 2  # one entity spanning several tiles
    if masked:
        ent[rng.rand(N) < 0.1] = B  # masked rows
    return ent, B


@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (256, 4)])
@pytest.mark.parametrize("seed,masked", [(0, False), (5, True)])
def test_plan_tiles_equals_jax(T, S, seed, masked):
    ent, B = _entities(seed, masked)
    counts = np.bincount(ent[ent < B], minlength=B)
    ours = tdc._plan_tiles(counts, T, S)
    ref = jdc._plan_tiles(counts, T, S)
    for a, b in zip(ours[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[3][0] == ref[3][0]
    for a, b in zip(ours[3][1:], ref[3][1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (256, 4)])
@pytest.mark.parametrize("seed,masked", [(0, False), (5, True)])
def test_device_derivation_equals_jax_and_the_host_pack(T, S, seed, masked):
    ent, B = _entities(seed, masked)
    N = ent.shape[0]
    counts = np.bincount(ent[ent < B], minlength=B)
    starts, shift, slots, meta = tdc._plan_tiles(counts, T, S)
    nt = meta[0] * T
    src, slot = tdc._derive_src_slot_device(
        torch.as_tensor(ent.astype(np.int32)), torch.as_tensor(starts),
        torch.as_tensor(shift), torch.as_tensor(slots), nt, N)
    jsrc, jslot = jdc._derive_src_slot_jit(
        jnp.asarray(ent.astype(np.int32)), jnp.asarray(starts),
        jnp.asarray(shift), jnp.asarray(slots), nt, N)
    assert src.dtype == slot.dtype == torch.int32
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))

    # the whole table, host pack against the derivation
    host = tdc.compile_categorical_table(
        ent, B, 0, N, np.float32, "cpu", fixed_ts=(T, S),
        derive_src_on_device=False)
    with tracing.recording() as rec:
        dev = tdc.compile_categorical_table(
            ent, B, 0, N, np.float32, "cpu", fixed_ts=(T, S),
            derive_src_on_device=True)
    assert [s.name for s in rec.spans] == [
        f"myfm.plan.{w}" for w in ("counts", "pack", "upload", "derive",
                                   "finalize")]
    for f in dataclasses.fields(host):
        a, b = getattr(host, f.name), getattr(dev, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(src.numpy(), host.src.numpy())
    if not masked:
        # and the plain numpy pack
        order = np.argsort(ent, kind="stable")
        ref = tdc._pack_tiles(ent[order], order, B, T, S)
        for r, t in zip(ref, (host.src, host.slot, host.ent_of_tile_row,
                              host.cont_in, host.cont_out, host.last_slot,
                              host.ent_slots, host.final_part)):
            np.testing.assert_array_equal(r, t.numpy())
    # masked rows keep their pad id and enter no tile
    assert int((host.ent_main == B).sum()) == int((ent == B).sum())
    assert np.isin(np.nonzero(ent == B)[0], host.src.numpy()).sum() == 0


def test_derivation_is_the_default_on_cuda_only():
    ent, B = _entities(1, False)
    tab = tdc.compile_categorical_table(ent, B, 0, ent.shape[0],
                                        np.float64, "cpu", fixed_ts=(64, 4))
    assert tab.src.device.type == "cpu"
    # on the CPU the default is the host pack: its myfm.plan.pack span
    # holds the native pack, and the plan equals the derivation's
    dev = tdc.compile_categorical_table(ent, B, 0, ent.shape[0],
                                        np.float64, "cpu", fixed_ts=(64, 4),
                                        derive_src_on_device=True)
    assert torch.equal(tab.src, dev.src) and torch.equal(tab.slot, dev.slot)


@pytest.mark.parametrize("max_id,dtype", [(200, np.uint8),
                                          (30_000, np.int16),
                                          (70_000, np.int32)])
def test_upload_ids_widens_to_int32(max_id, dtype):
    a = np.random.RandomState(0).randint(0, max_id + 1, 100)
    a[0] = max_id
    got = tdc._upload_ids(a, max_id, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jdc._upload_ids(a, max_id)), a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_greedy_color_equals_numpy_and_jax(seed):
    csc = sps.random(300, 120, density=0.06, format="csc",
                     random_state=seed)
    ours = tdesign.greedy_color(csc)
    plain = tdesign.greedy_color(csc, plain=True)
    ref = jdesign.greedy_color(csc)
    assert len(ours) == len(plain) == len(ref)
    for a, b, c in zip(ours, plain, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (128, 1), (256, 64)])
@pytest.mark.parametrize("seed", [0, 3])
def test_native_packing_equals_numpy_and_jax(T, S, seed):
    ent, B = _entities(seed, False)
    counts = np.bincount(ent, minlength=B)
    rows = tdc._packed_rows(counts, T, S)
    assert rows == tdc._packed_rows_reference(counts, T, S)
    assert rows == jdc._packed_rows(counts, T, S)
    order = np.argsort(ent, kind="stable")
    native = _native.pack_tiles_native(order, counts, ent.shape[0], T, S)
    plain = tdc._pack_tiles(ent[order], order, B, T, S)
    ref = jdc._pack_tiles(ent[order], order, B, T, S)
    assert native[0].shape[0] == rows + T  # the trailing pad tile
    for a, b, c in zip(native, plain, ref):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    src = tmp_path / "planner.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", src)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native planner failed") as exc:
        _native.build()
    assert "planner.cc" in str(exc.value)
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))
