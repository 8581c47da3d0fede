"""``characterize_batch`` of the PyTorch port (plain versions on the CPU)
against the JAX reference over the paper's config grid."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bitcells as jbitcells
from repro.core import characterize as jchz
from repro.core import macro as jmacro
from repro_torch.api import MacroConfig
from repro_torch.core import characterize as chz
from repro_torch.core import macro

# float32 metrics vs live JAX, worst relative gap over all columns as
# measured by running this file (``python tests/test_torch_characterize.py``):
# 5.8e-7 on the paper grid, 5.9e-7 on the 2,808-config grid. XLA folds and
# reassociates constants inside the jitted characterize; the port runs each
# op eagerly.
RTOL = 2e-6
GEOMETRY = ("rows", "cols", "mux", "bits")


def wide_space():
    """All 7 bitcells x word size 8-256 x 16-4096 words x 1-8 banks x level
    shifter: 2,808 configs."""
    return japi.design_space(
        mem_types=tuple(jbitcells.BITCELLS),
        word_sizes=(8, 16, 32, 64, 128, 256),
        num_words=tuple(2 ** k for k in range(4, 13)),
        banks=(1, 2, 4, 8), ls_options=(False, True))


def characterize_both(space):
    """(port, JAX) metric dicts of numpy arrays for one config list."""
    vecs = np.asarray(jnp.stack([c.to_vector() for c in space]))
    want = {k: np.asarray(v) for k, v in
            jchz.characterize_batch(jnp.asarray(vecs)).items()}
    got = {k: v.numpy() for k, v in
           chz.characterize_batch(torch.from_numpy(vecs.copy()),
                                  device="cpu").items()}
    return got, want


def max_rel(got, want):
    """Largest |got - want| / |want| over a column (0/0 counts as 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    return float(np.max(np.where(diff == 0, 0.0,
                                 diff / np.maximum(np.abs(want), 1e-300))))


@pytest.fixture(scope="module")
def both():
    return characterize_both(japi.design_space())


def test_same_metric_columns(both):
    got, want = both
    assert sorted(got) == sorted(want)
    assert all(v.shape == (120,) and v.dtype == np.float32
               for v in got.values())


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_columns_are_exact(both, name):
    got, want = both
    np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("name", [
    "area_um2", "area_array_um2", "f_read_hz", "f_write_hz", "f_op_hz",
    "bandwidth_bits_s", "bandwidth_total_bits_s", "t_read_s", "t_write_s",
    "e_read_j", "e_write_j", "p_dyn_w", "p_leak_w", "p_refresh_w",
    "retention_s"])
def test_float_metric_columns_within_rtol(both, name):
    got, want = both
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=0)


def test_wide_grid_matches():
    """Banks, all 7 bitcells, word sizes down to 8 and 4,096 words."""
    got, want = characterize_both(wide_space())
    for name in want:
        if name in GEOMETRY:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                       atol=0, err_msg=name)


def test_auto_mux_rounds_half_way_ratios_like_jax():
    """round(log2(sqrt(r))) at r = 2, 8, 32, ...: log2(sqrt(2)) is
    0.49999994 in jax and 0.49999997 in torch; both must round the same."""
    wz = np.full(9, 16.0, np.float32)
    nw = (16.0 * 2.0 ** np.arange(-3, 14, 2)).astype(np.float32)[:9]
    want = np.asarray(jmacro.auto_mux(jnp.asarray(wz), jnp.asarray(nw)))
    got = macro.auto_mux(torch.from_numpy(wz), torch.from_numpy(nw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", [
    MacroConfig("gc_ossi", 64, 256, level_shift=True),
    MacroConfig("sram6t", 128, 512, banks=4, sa_current_mode=True),
    MacroConfig("gc_osos_hvt", 8, 4096, banks=2, mux=4, level_shift=True),
], ids=lambda c: f"{c.mem_type}_{c.word_size}x{c.num_words}")
def test_characterize_config_matches(cfg):
    got = chz.characterize_config(cfg, device="cpu")
    want = jchz.characterize_config(jmacro.MacroConfig(
        **{f: getattr(cfg, f) for f in jmacro.VEC_FIELDS}))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0,
                                   err_msg=k)


def test_other_corners_raise():
    """Every operating corner characterizes now (tests/test_torch_corners.py
    holds them to the reference); what is not an operating corner raises."""
    vecs = torch.stack([MacroConfig().to_vector()])
    with pytest.raises(KeyError, match="unknown corner"):
        chz.characterize(vecs, tp="warm")
    with pytest.raises(TypeError):
        chz.characterize_config(MacroConfig(), tp=1.2, device="cpu")
    with pytest.raises(ValueError, match="vdd > 0"):
        chz.characterize_corners(vecs, ["nominal", (0.0, 300.0)],
                                 device="cpu")


if __name__ == "__main__":
    # the measurement behind RTOL: worst relative gap per grid
    for label, space in (("paper grid", japi.design_space()),
                         ("wide grid", wide_space())):
        got, want = characterize_both(space)
        worst = {k: max_rel(got[k], want[k]) for k in want}
        name = max(worst, key=worst.get)
        print(f"{label}: {len(space)} configs, worst max rel {worst[name]:.3e}"
              f" ({name}); geometry exact: "
              f"{all(worst[k] == 0.0 for k in GEOMETRY)}")
