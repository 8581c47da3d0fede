"""Card-only checks of the PyTorch port: the CUDA retention kernel against
its plain version on the card. They skip where no CUDA device is present;
on a GPU machine run them with ``python -m pytest -m cuda tests/``. This
file imports no jax, so it also runs where jax is not installed."""
import numpy as np
import pytest
import torch

from repro_torch.core import bitcells, retention
from repro_torch.kernels import ref
from repro_torch.kernels import retention as kretention

RTOL_KERNEL = 1e-5      # the reference's gate for its Pallas kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _nominal():
    """The 14 packed nominal rows: 7 bitcells x level shifter."""
    cells = bitcells.stack_bitcells()
    return torch.cat([retention.pack_retention_params(
        cells, torch.full((7,), float(ls))) for ls in (0, 1)]).numpy()


def _perturbed(n, seed=0):
    """``n`` rows drawn from the nominal ones: log-uniform factors in
    [0.1, 10] on ispec, i_floor, c_sn and w, vt shifted by +-50 mV."""
    base = _nominal().astype(np.float64)
    rng = np.random.default_rng(seed)
    p = base[rng.integers(0, len(base), n)]
    for field in (2, 4, 6, 7):
        p[:, field] *= 10.0 ** rng.uniform(-1.0, 1.0, n)
    p[:, 0] += rng.uniform(-0.05, 0.05, n)
    return p.astype(np.float32)


def _stiff():
    """Tiny storage caps and large gate leaks: RK4 overshoots, so the [0, 2]
    clip of V decides the crossing time."""
    base = _nominal()[7 + bitcells.MEM_TYPE["gc_sisi"]]
    rows = []
    for c_sn in (1e-18, 3e-18, 1e-17, 1e-16):
        for jg in (1e-9, 1e-7, 1e-5):
            rows.append(base.copy())
            rows[-1][6], rows[-1][5] = c_sn, jg
    return np.asarray(rows, np.float32)


ROWS = {"nominal-14": _nominal, "perturbed-130": lambda: _perturbed(130),
        "perturbed-4097": lambda: _perturbed(4097), "stiff-12": _stiff}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", sorted(ROWS))
def test_kernel_matches_plain_version_on_the_card(cuda, rows):
    params = torch.from_numpy(ROWS[rows]()).to(cuda)
    ts = retention.time_grid(cuda)
    before = kretention.retention_batch.launches
    got = kretention.retention_batch(params, ts)
    want = ref.retention_ref(params, ts)
    torch.cuda.synchronize()
    assert kretention.retention_batch.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL_KERNEL, atol=0)
    start = params[:, 8] < params[:, 9]
    assert torch.equal(got[start], want[start])


@pytest.mark.cuda
def test_main_path_retention_goes_through_the_kernel(cuda):
    cells = bitcells.stack_bitcells().to(cuda)
    ls = torch.ones(7, device=cuda)
    before = kretention.retention_batch.launches
    got = retention.retention_time_batch(cells, ls)
    torch.cuda.synchronize()
    assert kretention.retention_batch.launches == before + 1
    want = retention.retention_time_batch(cells.to("cpu"), ls.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL_KERNEL, atol=0)
