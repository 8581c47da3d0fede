"""Physics leaves of the PyTorch port against the JAX reference on the CPU:
the catalog, the time grid, stored level, read-margin threshold and the
transistor model. Inputs are numpy arrays made from a seed; JAX stays on
the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitcells as jbitcells
from repro.core import devices as jdevices
from repro.core import retention as jretention
from repro_torch import convert
from repro_torch.core import bitcells, devices, retention

# float32 metrics of the port vs live JAX: worst measured 9.9e-7 (mosfet_id
# on the voltage grid below; ``python tests/test_torch_physics.py`` prints
# it); exp/log1p/division round differently in the two libraries
RTOL = 2e-6


def _ref_stack(stack):
    return {f: np.asarray(getattr(stack, f)) for f in stack._fields}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("field", devices.DeviceParams._fields)
def test_converted_device_stack_equals_port_catalog(field):
    """The reference's device stack carried across by ``convert`` is the
    port's own catalog: ``_mk``'s calibrated ``ispec`` to 1 float32 ulp,
    every other field exactly."""
    conv = convert.params_from_numpy(
        devices.DeviceParams, _ref_stack(jbitcells.DEVICE_STACK), "cpu")
    got = getattr(conv, field).numpy()
    own = getattr(bitcells.DEVICE_STACK, field).numpy()
    if field == "ispec":
        assert _ulps(got, own).max() <= 1
    else:
        np.testing.assert_array_equal(got, own)


def test_converted_bitcell_stack_equals_port_catalog():
    conv = convert.params_from_numpy(
        bitcells.BitcellParams, _ref_stack(jbitcells.stack_bitcells()), "cpu")
    own = bitcells.stack_bitcells()
    for f in bitcells.BitcellParams._fields:
        np.testing.assert_array_equal(getattr(conv, f).numpy(),
                                      getattr(own, f).numpy(), err_msg=f)
    assert bitcells.MEM_TYPE_ORDER == jbitcells.MEM_TYPE_ORDER
    assert bitcells.DEVICE_ORDER == jbitcells.DEVICE_ORDER


def test_convert_rejects_wrong_fields_and_dtypes():
    arrays = _ref_stack(jbitcells.DEVICE_STACK)
    with pytest.raises(KeyError):
        convert.params_from_numpy(devices.DeviceParams,
                                  {**arrays, "extra": arrays["vt"]}, "cpu")
    with pytest.raises(TypeError):
        convert.params_from_numpy(
            devices.DeviceParams,
            {**arrays, "vt": arrays["vt"].astype(np.float64)}, "cpu")


def test_time_grid_reproduces_jax_logspace_exactly():
    """``time_grid`` reproduces the reference's float32 logspace value for
    value (torch.logspace differs in most points by up to 3.3e-6)."""
    ts = convert.time_grid_from_numpy(np.asarray(jretention.time_grid()),
                                      "cpu")
    assert ts.shape == (retention.N_STEPS + 1,)
    np.testing.assert_array_equal(retention.time_grid().numpy(), ts.numpy())


@pytest.mark.parametrize("ls", [0, 1])
def test_sn_high_level_and_read_margin_threshold_match(ls):
    cells = bitcells.stack_bitcells()
    got_v0 = bitcells.sn_high_level(cells, torch.full((7,), float(ls)))
    got_vmin = retention.read_margin_threshold(cells)
    for i, name in enumerate(jbitcells.MEM_TYPE_ORDER):
        cell = jbitcells.BITCELLS[name]
        assert float(got_v0[i]) == float(jbitcells.sn_high_level(cell, ls))
        assert float(got_vmin[i]) == float(
            jretention.read_margin_threshold(cell))


def mosfet_id_both(name):
    """(port, JAX) drain currents of one catalog device over a 37 x 33 grid
    of (vgs, vds) with seeded widths."""
    vg, vd = np.meshgrid(np.linspace(-0.2, 1.6, 37, dtype=np.float32),
                         np.linspace(0.0, 1.6, 33, dtype=np.float32))
    vgs, vds = vg.ravel(), vd.ravel()
    w = np.random.default_rng(7).uniform(0.05, 2.0, vgs.size).astype(
        np.float32)
    i = jbitcells.DEV[name]
    want = jdevices.mosfet_id(jdevices.take_device(jbitcells.DEVICE_STACK, i),
                              vgs, vds, w)
    got = devices.mosfet_id(devices.take_device(bitcells.DEVICE_STACK, i),
                            torch.from_numpy(vgs), torch.from_numpy(vds),
                            torch.from_numpy(w))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", jbitcells.DEVICE_ORDER)
def test_mosfet_id_matches_on_a_voltage_grid(name):
    got, want = mosfet_id_both(name)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("ls", [0, 1])
def test_leak_current_and_retention_estimate_match(ls):
    cells = bitcells.stack_bitcells()
    v = np.random.default_rng(ls).uniform(0.0, 1.2, 7).astype(np.float32)
    got_leak = retention.leak_current(cells, torch.from_numpy(v))
    got_est = retention.retention_estimate(cells, torch.full((7,), float(ls)))
    for i, name in enumerate(jbitcells.MEM_TYPE_ORDER):
        cell = jbitcells.BITCELLS[name]
        np.testing.assert_allclose(
            float(got_leak[i]),
            float(jretention.leak_current(cell, jnp.float32(v[i]))),
            rtol=RTOL, atol=0, err_msg=name)
        np.testing.assert_allclose(
            float(got_est[i]), float(jretention.retention_estimate(cell, ls)),
            rtol=RTOL, atol=0, err_msg=name)


if __name__ == "__main__":
    # the measurements behind RTOL and the 1-ulp ispec bound
    worst = 0.0
    for got, want in map(mosfet_id_both, jbitcells.DEVICE_ORDER):
        diff = np.abs(got.astype(np.float64) - want)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(diff == 0, 0.0, diff / np.abs(want))
        worst = max(worst, float(rel.max()))
    print(f"mosfet_id on the voltage grid: worst max rel {worst:.3e}")
    ref = _ref_stack(jbitcells.DEVICE_STACK)
    for f in devices.DeviceParams._fields:
        ulps = _ulps(getattr(bitcells.DEVICE_STACK, f).numpy(), ref[f])
        print(f"catalog {f}: max ulps {ulps.max()}")
