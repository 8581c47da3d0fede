"""The retention kernel's plain version and the main-path retention of the
PyTorch port against the JAX reference (its oracle, its Pallas kernel in
interpret mode, and its solver)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitcells as jbitcells
from repro.core import devices as jdevices
from repro.core import retention as jretention
from repro.kernels.ref import retention_ref as jax_retention_ref
from repro.kernels.retention_kernel import retention_pallas
from repro_torch import api
from repro_torch.core import bitcells, corners, retention
from repro_torch.kernels import ref
from repro_torch.kernels import retention as kretention

# kernel-level gate, the one the reference holds its Pallas kernel to
# (tests/test_kernels.py); the port's plain version meets it against both
RTOL_KERNEL = 1e-5
# main-path retention vs the reference solver: worst measured 4.9e-7
# (``python tests/test_torch_retention.py`` prints it)
RTOL_SOLVER = 2e-6

NAMES = jbitcells.MEM_TYPE_ORDER


def _jax_packed_rows():
    """(14, 10) rows of the 7 bitcells x ls, packed from the reference the
    way tests/test_kernels.py packs them."""
    rows = []
    for ls in (0, 1):
        for name in NAMES:
            c = jbitcells.BITCELLS[name]
            wd = jdevices.take_device(jbitcells.DEVICE_STACK, int(c.write_dev))
            rd = jdevices.take_device(jbitcells.DEVICE_STACK, int(c.read_dev))
            rows.append([float(wd.vt), float(wd.n), float(wd.ispec),
                         float(wd.eta_dibl), float(wd.i_floor),
                         float(rd.j_gate * c.w_read / 1.1), float(c.c_sn),
                         float(c.w_write),
                         float(jbitcells.sn_high_level(c, ls)),
                         float(jretention.read_margin_threshold(c))])
    return np.asarray(rows, np.float32)


def _perturbed_rows(n, seed):
    """``n`` rows drawn from the 14 nominal rows, with log-uniform factors in
    [0.1, 10] on ispec, i_floor, c_sn and w and vt shifted by +-50 mV."""
    rng = np.random.default_rng(seed)
    base = _jax_packed_rows().astype(np.float64)
    p = base[rng.integers(0, len(base), n)]
    for field in (2, 4, 6, 7):
        p[:, field] *= 10.0 ** rng.uniform(-1.0, 1.0, n)
    p[:, 0] += rng.uniform(-0.05, 0.05, n)
    return p.astype(np.float32)


def _stiff_rows():
    """The level-shifted gc_sisi row with a tiny storage cap and a large gate
    leak: RK4 overshoots on the first steps, so the [0, 2] clip of V decides
    the crossing time."""
    base = _jax_packed_rows()[len(NAMES) + NAMES.index("gc_sisi")]
    rows = []
    for c_sn in (1e-18, 3e-18, 1e-17, 1e-16):
        for jg in (1e-9, 1e-7, 1e-5):
            rows.append(base.copy())
            rows[-1][6], rows[-1][5] = c_sn, jg
    return np.asarray(rows, np.float32)


ROWS = {"nominal-14": _jax_packed_rows,
        "perturbed-130": lambda: _perturbed_rows(130, 0),
        "stiff-12": _stiff_rows}


@pytest.fixture(scope="module")
def ts_np():
    return np.array(jretention.time_grid())


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_plain_kernel_version_matches_jax_oracle_and_pallas(rows, ts_np):
    params = ROWS[rows]()
    got = ref.retention_ref(torch.from_numpy(params),
                            torch.from_numpy(ts_np)).numpy()
    want_ref = np.asarray(jax_retention_ref(jnp.asarray(params),
                                            jnp.asarray(ts_np)))
    want_pallas = np.asarray(retention_pallas(jnp.asarray(params),
                                              jnp.asarray(ts_np),
                                              interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL_KERNEL, atol=0)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL_KERNEL, atol=0)
    # the kernel's start state: rows with v0 < v_min return ts[-1]
    start = params[:, 8] < params[:, 9]
    assert start.any() or rows == "stiff-12"
    np.testing.assert_array_equal(got[start], ts_np[-1])


def _paper_grid_rows():
    """(120, 10) rows of the paper grid (``design_space()``), packed as
    ``explore`` hands them to the kernel."""
    space = api.design_space()
    cells = bitcells.take_bitcell(bitcells.stack_bitcells(), torch.tensor(
        [bitcells.MEM_TYPE[c.mem_type] for c in space]))
    return retention.pack_retention_params(
        cells, torch.tensor([float(c.level_shift) for c in space])).numpy()


def _kernel_order(params: torch.Tensor, ts: torch.Tensor,
                  ut: float = ref.UT) -> torch.Tensor:
    """retention.cu's order of operations, in float32 on the CPU: u1 =
    -vt_eff / (n UT) and -leak / max(c_sn, 1e-18) correctly rounded, as
    the plain version divides (the kernel's Markstein-corrected quotients
    are IEEE division's), (-vt_eff - n v) / (n UT) taken as
    u1 - v * (1 / UT) with 1 / UT rounded once, and each step's dt, dt / 2
    and dt / 6 taken once from ts. The crossing and the start-crossed rows
    are the plain version's."""
    vt, n, ispec, eta, i_floor, jg, c_sn, w, v, v_min = params.unbind(1)
    nut = n * ut
    c = torch.clamp_min(c_sn, 1e-18)
    inv_ut = torch.reciprocal(torch.tensor(ut, dtype=torch.float32))

    def f(v):
        v = torch.clamp_min(v, 0.0)
        vt_eff = vt - eta * v
        u1 = (0.0 - vt_eff) / nut
        u2 = u1 - v * inv_ut
        i_ch = ispec * (ref._F(u1) - ref._F(u2))
        return -((torch.clamp_min(i_ch, 0.0) + i_floor) * w + jg * v) / c

    dts = ts[1:] - ts[:-1]
    half_dts, sixth_dts = 0.5 * dts, dts / 6.0
    t_ret = ts[-1].expand_as(v)
    found = v < v_min
    for i in range(dts.shape[0]):
        k1 = f(v)
        k2 = f(v + half_dts[i] * k1)
        k3 = f(v + half_dts[i] * k2)
        k4 = f(v + dts[i] * k3)
        v_new = torch.clamp(v + sixth_dts[i] * (k1 + 2 * k2 + 2 * k3 + k4),
                            0.0, 2.0)
        crossed = (v_new < v_min) & ~found
        frac = torch.clamp((v - v_min) / torch.clamp_min(v - v_new, 1e-9),
                           0.0, 1.0)
        t0, t1 = ts[i], ts[i + 1]
        t_cross = torch.exp(torch.log(t0) + frac *
                            (torch.log(t1) - torch.log(t0)))
        t_ret = torch.where(crossed, t_cross, t_ret)
        found = found | crossed
        v = v_new
    return t_ret


MIRROR_ROWS = {"paper-grid-120": _paper_grid_rows,
               "perturbed-1000": lambda: _perturbed_rows(1000, 5),
               "stiff-12": _stiff_rows}


@pytest.mark.parametrize("rows", sorted(MIRROR_ROWS))
def test_kernel_order_of_operations_matches_plain_version_and_jax(rows,
                                                                 ts_np):
    """The CUDA kernel's order of operations (the plain version's
    divisions, 1 / UT rounded once, dt / 6 from shared memory) holds the
    kernel gate against the plain version and the JAX oracle before it
    reaches the card; rows that start crossed come out as ts[-1]
    exactly."""
    params = MIRROR_ROWS[rows]()
    got = _kernel_order(torch.from_numpy(params),
                        torch.from_numpy(ts_np)).numpy()
    plain = ref.retention_ref(torch.from_numpy(params),
                              torch.from_numpy(ts_np)).numpy()
    oracle = np.asarray(jax_retention_ref(jnp.asarray(params),
                                          jnp.asarray(ts_np)))
    np.testing.assert_allclose(got, plain, rtol=RTOL_KERNEL, atol=0)
    np.testing.assert_allclose(got, oracle, rtol=RTOL_KERNEL, atol=0)
    start = params[:, 8] < params[:, 9]
    # the paper grid has no HVT cells; the perturbed rows are drawn from
    # all 14 nominal ones, three of which start crossed
    assert start.any() == (rows == "perturbed-1000")
    np.testing.assert_array_equal(got[start], plain[start])
    np.testing.assert_array_equal(got[start], ts_np[-1])


def _corner_rows(op, n, seed):
    """The paper grid's rows and ``n`` rows perturbed from the 14 packed
    rows, all packed at operating point ``op``; and its TechParams."""
    tp = corners.resolve(corners.as_operating_point(op))
    space = api.design_space()
    cells = bitcells.take_bitcell(bitcells.stack_bitcells(), torch.tensor(
        [bitcells.MEM_TYPE[c.mem_type] for c in space]))
    grid = retention.pack_retention_params(
        cells, torch.tensor([float(c.level_shift) for c in space]), tp)
    base = torch.cat([retention.pack_retention_params(
        bitcells.stack_bitcells(), torch.full((7,), float(ls)), tp)
        for ls in (0, 1)]).numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    p = base[rng.integers(0, len(base), n)]
    for field in (2, 4, 6, 7):
        p[:, field] *= 10.0 ** rng.uniform(-1.0, 1.0, n)
    p[:, 0] += rng.uniform(-0.05, 0.05, n)
    return torch.cat([grid, torch.from_numpy(p.astype(np.float32))]), tp


@pytest.mark.parametrize("op", ["hot", "cold", "low_vdd", (1.2, 233.0)],
                         ids=str)
def test_kernel_order_matches_plain_version_at_corners(op, ts_np):
    """At each corner's thermal voltage, on the paper grid's rows and 1,000
    perturbed rows packed at the corner: the kernel's order of operations
    within the kernel gate of the plain version (it differs only in
    u1 - v / UT, which no threshold lets reach the result), start-crossed
    rows exact."""
    params, tp = _corner_rows(op, 1000, 9)
    ts = torch.from_numpy(ts_np)
    got = _kernel_order(params, ts, tp.ut)
    plain = ref.retention_ref(params, ts, tp.ut)
    torch.testing.assert_close(got, plain, rtol=RTOL_KERNEL, atol=0)
    start = params[:, 8] < params[:, 9]
    assert start.any()
    assert torch.equal(got[start], plain[start])


def test_wrapper_on_cpu_is_the_plain_version(ts_np):
    params = torch.from_numpy(_perturbed_rows(33, 1))
    ts = torch.from_numpy(ts_np)
    torch.testing.assert_close(kretention.retention_batch(params, ts),
                               ref.retention_ref(params, ts), rtol=0, atol=0)


def test_pack_matches_the_reference_packing():
    """``pack_retention_params`` gives the rows tests/test_kernels.py packs
    from the reference (``ispec`` within its 1-ulp calibration drift)."""
    got = torch.cat([retention.pack_retention_params(
        bitcells.stack_bitcells(), torch.full((7,), float(ls)))
        for ls in (0, 1)]).numpy()
    np.testing.assert_allclose(got, _jax_packed_rows(), rtol=RTOL_SOLVER,
                               atol=0)


@pytest.mark.parametrize("ls", [0, 1])
def test_retention_time_batch_matches_reference_solver(ls):
    """All 7 cells at nominal, the start-crossed rows (HVT write device
    without a level shifter) included: the kernel path returns what
    ``retention_time`` returns, ~ts[0], not the kernel's ts[-1]."""
    cells = bitcells.stack_bitcells()
    got = retention.retention_time_batch(
        cells, torch.full((7,), float(ls))).numpy()
    plain = retention.retention_time(cells, torch.full((7,), float(ls)))
    want = np.array([float(jretention.retention_time(jbitcells.BITCELLS[n],
                                                     ls)) for n in NAMES],
                    np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL_SOLVER, atol=0)
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL_SOLVER, atol=0)
    crossed = [NAMES.index(n) for n in ("gc_sisi_hvt", "gc_ossi_hvt",
                                        "gc_osos_hvt")]
    if ls == 0:
        np.testing.assert_array_equal(got[crossed], want[crossed])
        assert (got[crossed] < 2e-9).all()
    else:
        assert (got[crossed] > 1e-6).all()


@pytest.mark.parametrize("corner", ["hot", "cold", corners.LOW_VDD,
                                    corners.TechParams.from_op(corners.HOT)])
def test_retention_time_batch_refuses_other_corners(corner):
    """One launch takes one thermal voltage: ``corner`` alone runs, while a
    TechParams stacked over the nominal point and ``corner`` is refused."""
    cells, ls = bitcells.stack_bitcells(), torch.zeros(7)
    assert torch.isfinite(retention.retention_time_batch(cells, ls,
                                                         tp=corner)).all()
    op = corners.HOT if isinstance(corner, corners.TechParams) else corner
    with pytest.raises(ValueError, match="one operating corner"):
        retention.retention_time_batch(
            cells, ls, tp=corners.stack_tech([corners.NOMINAL, op]))


if __name__ == "__main__":
    # the measurements behind RTOL_KERNEL and RTOL_SOLVER
    ts = np.array(jretention.time_grid())
    for name, make in sorted(ROWS.items()):
        p = make()
        got = ref.retention_ref(torch.from_numpy(p), torch.from_numpy(ts))
        want = np.asarray(jax_retention_ref(jnp.asarray(p), jnp.asarray(ts)))
        print(f"plain kernel version vs JAX oracle, {name}: max rel "
              f"{np.max(np.abs(got.numpy() - want) / want):.3e}")
    for name, make in sorted(MIRROR_ROWS.items()):
        p = torch.from_numpy(make())
        got = _kernel_order(p, torch.from_numpy(ts))
        plain = ref.retention_ref(p, torch.from_numpy(ts))
        want = np.asarray(jax_retention_ref(jnp.asarray(p.numpy()),
                                            jnp.asarray(ts)))
        print(f"kernel order of operations, {name}: max rel vs plain "
              f"{((got - plain).abs() / plain).max().item():.3e}, vs JAX "
              f"oracle {np.max(np.abs(got.numpy() - want) / want):.3e}")
    for op in ("hot", "cold", "low_vdd", (1.2, 233.0)):
        p, tp = _corner_rows(op, 1000, 9)
        got = _kernel_order(p, torch.from_numpy(ts), tp.ut)
        plain = ref.retention_ref(p, torch.from_numpy(ts), tp.ut)
        print(f"kernel order of operations at {op}, paper grid + 1,000 "
              f"perturbed rows: max rel vs plain "
              f"{((got - plain).abs() / plain).max().item():.3e}")
    for ls in (0, 1):
        got = retention.retention_time_batch(bitcells.stack_bitcells(),
                                             torch.full((7,), float(ls)))
        want = np.array([float(jretention.retention_time(
            jbitcells.BITCELLS[n], ls)) for n in NAMES], np.float32)
        print(f"retention_time_batch vs JAX retention_time, ls={ls}: max rel "
              f"{np.max(np.abs(got.numpy() - want) / want):.3e}")
