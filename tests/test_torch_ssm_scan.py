"""The selective-scan plain version of the PyTorch port (what the wrapper
runs on the CPU and what the CUDA kernel is held to on the card) against the
JAX reference: its Pallas kernel in interpret mode, its sequential oracle
``repro.kernels.ref.ssm_scan_ref`` (y and the final state) and the model's
chunked associative scan ``repro.models.ssm.ssm_scan_chunked``.

Tolerance: 1e-4, rtol and atol, the reference's own gate for its kernel
(``tests/test_kernels.py``). Measured worst case on the CPU: 1.2e-6 abs on
y and 3.0e-7 on h_final (``python tests/test_torch_ssm_scan.py`` prints
them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssm_scan_ref as jax_ssm_scan_ref
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models.ssm import ssm_scan_chunked
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as kssm

TOL = 1e-4


def _inputs(B, S, di, n, seed, A=None, D=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, di)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(B, S, di)).astype(np.float32)
    if A is None:
        A = -rng.uniform(0.5, 2.0, size=(di, n)).astype(np.float32)
    Bc = rng.normal(size=(B, S, n)).astype(np.float32)
    Cc = rng.normal(size=(B, S, n)).astype(np.float32)
    if D is None:
        D = rng.normal(size=(di,)).astype(np.float32)
    return x, dt, A, Bc, Cc, D


def _port(arrays):
    y, h = ref.ssm_scan_ref(*(torch.from_numpy(a) for a in arrays))
    return y.numpy(), h.numpy()


def _jax_ref(arrays):
    x, dt, A, Bc, Cc, D = (jnp.asarray(a) for a in arrays)
    B, _, di = x.shape
    return jax_ssm_scan_ref(x, dt, A, Bc, Cc, D,
                            jnp.zeros((B, di, A.shape[1]), jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,S,di,n", [(1, 128, 256, 16), (2, 256, 512, 8),
                                      (1, 64, 1024, 16)])
def test_plain_version_matches_pallas_kernel_and_oracle(B, S, di, n):
    arrays = _inputs(B, S, di, n, 2)
    y, h = _port(arrays)
    pallas = ssm_scan_pallas(*(jnp.asarray(a) for a in arrays),
                             block_d=min(256, di), chunk=min(64, S),
                             interpret=True)
    _close(y, pallas)
    y_ref, h_ref = _jax_ref(arrays)
    _close(y, y_ref)
    _close(h, h_ref)


@pytest.mark.parametrize("chunk", [32, 128])
def test_plain_version_matches_pallas_chunkings(chunk):
    """The reference's chunk-invariance case: one sequential scan here
    against the Pallas kernel cut into chunks of 32 and of 128."""
    B, S, di, n = 1, 128, 256, 8
    arrays = _inputs(B, S, di, n, 3, A=-np.ones((di, n), np.float32),
                     D=np.zeros((di,), np.float32))
    pallas = ssm_scan_pallas(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                             interpret=True)
    _close(_port(arrays)[0], pallas)


# di that no Pallas block divides (hymba's 3200 among them) and S that no
# chunk divides: the Pallas kernel asserts both, so these go to the oracle
# and to the model's chunked associative scan
@pytest.mark.parametrize("B,S,di,n", [(2, 45, 200, 8), (1, 37, 3200, 16),
                                      (3, 130, 96, 4)])
def test_plain_version_ragged_against_oracle_and_model_scan(B, S, di, n):
    arrays = _inputs(B, S, di, n, 4)
    y, h = _port(arrays)
    y_ref, h_ref = _jax_ref(arrays)
    _close(y, y_ref)
    _close(h, h_ref)
    x, dt, A, Bc, Cc, D = (jnp.asarray(a) for a in arrays)
    y_m, h_m = ssm_scan_chunked(x, dt, A, Bc, Cc, D,
                                jnp.zeros((B, di, n), jnp.float32), chunk=16)
    _close(y, y_m)
    _close(h, h_m)


LOG2E = 1.4426950408889634


def _kernel_order(x, dt, A, Bc, Cc, D, group, exp2=True):
    """ssm_scan.cu's order of operations, in float32 on the CPU: the n
    states of a channel split over G = min(group, n) lanes, lane g holding
    states g*n/G .. (g+1)*n/G - 1, each lane summing h_j * C_j over its
    states in order, then the butterfly over the lanes (step m adds the
    value of lane g ^ m), lane 0's sum plus D * x as y; exp(dt * A) as
    exp2(dt * (A * log2(e))) when ``exp2``."""
    Bsz, S, di = x.shape
    n = A.shape[1]
    G = min(group, n)
    NL = n // G
    a = (A * LOG2E if exp2 else A).view(di, G, NL)
    h = torch.zeros((Bsz, di, G, NL), dtype=torch.float32)
    ys = []
    for t in range(S):
        dt_t = dt[:, t, :, None, None]
        e = torch.exp2(dt_t * a) if exp2 else torch.exp(dt_t * a)
        dtx = (dt[:, t] * x[:, t])[..., None, None]
        h = e * h + dtx * Bc[:, t].view(Bsz, 1, G, NL)
        c_t = Cc[:, t].view(Bsz, 1, G, NL)
        lane = torch.zeros((Bsz, di, G), dtype=torch.float32)
        for j in range(NL):
            lane = lane + h[..., j] * c_t[..., j]
        m = 1
        while m < G:
            lane = lane + lane[..., torch.arange(G) ^ m]
            m <<= 1
        ys.append(lane[..., 0] + D * x[:, t])
    return torch.stack(ys, dim=1), h.reshape(Bsz, di, n)


# the reference's shapes, a di that no 32-channel block divides and n = 4
# (fewer states than lanes of a group of 8)
MIRROR_SHAPES = [(1, 128, 256, 16), (2, 256, 512, 8), (1, 64, 1024, 16),
                 (2, 45, 200, 8), (3, 130, 96, 4)]


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("B,S,di,n", MIRROR_SHAPES)
def test_kernel_order_of_operations_matches_plain_version_and_jax(B, S, di,
                                                                  n, group):
    """The CUDA kernel's lane split, butterfly sum and exp2 hold the kernel
    gate against the plain version and the JAX oracle before they reach
    the card (groups of 2, 4 and 8 lanes: the shipped one and the variants
    chip_smoke.py times)."""
    arrays = _inputs(B, S, di, n, 8)
    y, h = _kernel_order(*(torch.from_numpy(a) for a in arrays), group)
    y_plain, h_plain = _port(arrays)
    _close(y.numpy(), y_plain)
    _close(h.numpy(), h_plain)
    y_ref, h_ref = _jax_ref(arrays)
    _close(y.numpy(), y_ref)
    _close(h.numpy(), h_ref)


# gradients of the wrapper on the CPU (its plain version under autograd)
# against jax.grad of the JAX model's chunked scan, for the loss sum(y * wy)
# + sum(h_final * wh): max|port - jax| / max|jax| per gradient; measured
# worst 4.1e-7
RTOL_GRAD = 5e-6
# (B, S, di, n, chunk): one chunk; several chunks; a ragged S (one chunk);
# the reduced hymba's scan (di 128, n 8)
GRAD_SHAPES = [(1, 64, 48, 16, 128), (2, 96, 32, 8, 32), (2, 45, 40, 4, 128),
               (2, 24, 128, 8, 128)]


def scan_grad_gaps(shape, seed=9):
    B, S, di, n, chunk = shape
    arrays = _inputs(B, S, di, n, seed)
    rng = np.random.default_rng(seed + 1)
    wy = rng.normal(size=(B, S, di)).astype(np.float32)
    wh = rng.normal(size=(B, di, n)).astype(np.float32)

    def jax_loss(*xs):
        y, h = ssm_scan_chunked(*xs, jnp.zeros((B, di, n), jnp.float32),
                                chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)
    want = jax.grad(jax_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, h = kssm.ssm_scan(*leaves)
    loss = (y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
    got = torch.autograd.grad(loss, leaves)
    return [float(np.abs(g.numpy() - np.asarray(j)).max()
                  / np.abs(np.asarray(j)).max()) for g, j in zip(got, want)]


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
def test_wrapper_gradients_match_jax_grad_of_the_model_scan(shape):
    assert max(scan_grad_gaps(shape)) <= RTOL_GRAD


def test_wrapper_runs_the_plain_version_on_the_cpu():
    arrays = [torch.from_numpy(a) for a in _inputs(2, 20, 48, 16, 5)]
    before = kssm.ssm_scan.launches
    y, h = kssm.ssm_scan(*arrays)
    y_ref, h_ref = ref.ssm_scan_ref(*arrays)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    assert kssm.ssm_scan.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    good = [torch.from_numpy(a) for a in _inputs(1, 4, 8, 4, 6)]
    with pytest.raises(TypeError):
        kssm.ssm_scan(good[0].double(), *good[1:])
    with pytest.raises(ValueError):     # Bc with the wrong state size
        kssm.ssm_scan(*good[:3], good[3][..., :3], *good[4:])
    with pytest.raises(ValueError):
        kssm.ssm_scan(good[0].transpose(1, 2).contiguous().transpose(1, 2),
                      *good[1:])
    # neither the CPU nor a CUDA device: no plain-version fallback
    with pytest.raises(ValueError, match="cuda or cpu"):
        kssm.ssm_scan(*(t.to("meta") for t in good))


# ---------------------------------------------------------------------------
# the backward kernel's order of operations (kernels/csrc/ssm_scan_bwd.cu)
# ---------------------------------------------------------------------------

KT = 64          # steps a chunk: the forward saves the state entering each
BWD_LANES = 4    # lanes a channel in the gradient stage
WARP_CH = 8      # channels a warp there; 4 warps a block of 32 channels
BLOCK_WARPS = 4


def _fma(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding there,
    then to float32 (a double rounding the card's FMA does not make, rarely
    one ulp apart)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sums(terms, coef):
    """sum_j coef_j terms_j as the kernel forms it: each of the 4 lanes of a
    channel an FMA chain over its n/4 states in order from 0, then the
    butterfly over the lanes, (l0 + l1) + (l2 + l3). terms (B, di, n), coef
    broadcast to it."""
    n = terms.shape[-1]
    coef = coef.expand_as(terms)
    lanes = []
    for lane in range(BWD_LANES):
        acc = torch.zeros(terms.shape[:-1], dtype=torch.float32)
        for j in range(lane * n // BWD_LANES, (lane + 1) * n // BWD_LANES):
            acc = _fma(coef[..., j], terms[..., j], acc)
        lanes.append(acc)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _channel_sums(v):
    """sum over the channels (axis 2) as the kernel forms it: zero-padded to
    blocks of 32; in a warp's 8 channels c = 4 b2 + 2 b1 + b0 a tree over
    b2, then b1, then b0 (warp_channel_sum); the block's 4 warps in order;
    the blocks in order from a zero."""
    B, S, di, n = v.shape
    width = BLOCK_WARPS * WARP_CH
    nblk = -(-di // width)
    v = torch.cat([v, v.new_zeros((B, S, nblk * width - di, n))], 2)
    v = v.view(B, S, nblk, BLOCK_WARPS, 2, 2, 2, n)   # block, warp, b2 b1 b0
    for _ in range(3):
        v = v[:, :, :, :, 0] + v[:, :, :, :, 1]
    total = torch.zeros((B, S, n), dtype=torch.float32)
    for blk in range(nblk):
        acc = v[:, :, blk, 0]
        for w in range(1, BLOCK_WARPS):
            acc = acc + v[:, :, blk, w]
        total = total + acc
    return total


def _bwd_kernel_order(x, dt, A, Bc, Cc, D, dy, dh=None):
    """ssm_scan_bwd.cu's gradients in float32 on the CPU, in its order of
    operations: (1) per chunk k >= 1 of KT steps the adjoint walk from zero
    and the product of its factors, L_k and P_k; (2) the carries r_{k-1} =
    fma(P_k, r_k, L_k) from dh_final; (3) per chunk the walk from r_k over
    the forward's states (exp2 factors, the forward's FMA), dx and ddt from
    the four lanes' sums, dA and dD partials per (b, chunk), dB and dC terms
    per step; (4) dB, dC summed over the channels (``_channel_sums``), dA,
    dD over b, then chunk, in order."""
    Bsz, S, di = x.shape
    n = A.shape[1]
    K = -(-S // KT)
    a2 = A * LOG2E

    def factor(t):
        return torch.exp2(dt[:, t, :, None] * a2)        # (B, di, n)

    chunks = [range(k * KT, min(S, (k + 1) * KT)) for k in range(K)]
    L = torch.zeros((Bsz, K, di, n), dtype=torch.float32)
    P = torch.ones((Bsz, K, di, n), dtype=torch.float32)
    for k in range(1, K):
        g, p = L[:, k].clone(), P[:, k].clone()
        for t in reversed(chunks[k]):
            e = factor(t)
            g = _fma(Cc[:, t, None, :], dy[:, t, :, None], g) * e
            p = p * e
        L[:, k], P[:, k] = g, p
    R = torch.zeros((Bsz, K, di, n), dtype=torch.float32)
    r = torch.zeros((Bsz, di, n)) if dh is None else dh.clone()
    for k in range(K - 1, 0, -1):
        R[:, k] = r
        r = _fma(P[:, k], r, L[:, k])
    R[:, 0] = r

    dtx = dt * x
    h = torch.zeros((Bsz, di, n), dtype=torch.float32)
    states = []                       # the state entering each step
    for t in range(S):
        states.append(h)
        h = _fma(factor(t), h, dtx[:, t, :, None] * Bc[:, t, None, :])
    states.append(h)

    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    tb, tc = torch.zeros((2, Bsz, S, di, n), dtype=torch.float32)
    pA = torch.zeros((Bsz, K, di, n), dtype=torch.float32)
    pD = torch.zeros((Bsz, K, di), dtype=torch.float32)
    for k in range(K):
        g, dA_k, dD_k = R[:, k].clone(), pA[:, k], pD[:, k]
        for t in reversed(chunks[k]):
            e, dy_t = factor(t), dy[:, t]
            g = _fma(Cc[:, t, None, :], dy_t[..., None], g)
            q = g * (e * states[t])
            pq = _lane_sums(q, A[None])
            dA_k = _fma(dt[:, t, :, None], q, dA_k)
            px = _lane_sums(g, Bc[:, t, None, :])
            tb[:, t] = g * dtx[:, t, :, None]
            tc[:, t] = dy_t[..., None] * states[t + 1]
            g = g * e
            dx[:, t] = _fma(D, dy_t, dt[:, t] * px)
            ddt[:, t] = _fma(x[:, t], px, pq)
            dD_k = _fma(dy_t, x[:, t], dD_k)
        pA[:, k], pD[:, k] = dA_k, dD_k
    dA = torch.zeros((di, n), dtype=torch.float32)
    dD = torch.zeros((di,), dtype=torch.float32)
    for b in range(Bsz):
        for k in range(K):
            dA, dD = dA + pA[b, k], dD + pD[b, k]
    return dx, ddt, dA, _channel_sums(tb), _channel_sums(tc), dD


# max|mirror - want| / max|want| per gradient against the plain version
# under autograd and against jax.grad of the JAX model's chunked scan;
# measured worst 4.1e-7 (``python tests/test_torch_ssm_scan.py``)
RTOL_BWD_ORDER = 5e-6
# (B, S, di, n, with dh_final): several chunks with a short last one; S
# below one chunk; S a whole number of chunks; di no 32-channel block
# divides (a warp of a block only partly used); n = 4, 8 and 16
BWD_ORDER_SHAPES = [(2, 150, 40, 16, True), (1, 40, 48, 8, False),
                    (2, 128, 32, 4, True), (1, 193, 70, 16, False)]


def bwd_order_gaps(shape, seed=12):
    """[plain, jax] lists of the six gradients' relative gaps of the
    mirror, for the loss sum(y * dy) (+ sum(h_final * dh))."""
    B, S, di, n, with_dh = shape
    arrays = _inputs(B, S, di, n, seed)
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(B, S, di)).astype(np.float32)
    dh = rng.normal(size=(B, di, n)).astype(np.float32) if with_dh else None
    ts = [torch.from_numpy(a) for a in arrays]
    got = _bwd_kernel_order(*ts, torch.from_numpy(dy),
                            None if dh is None else torch.from_numpy(dh))
    plain = ref.ssm_scan_ref_grads(*ts, torch.from_numpy(dy),
                                   None if dh is None else torch.from_numpy(dh))

    def jax_loss(*xs):
        y, h = ssm_scan_chunked(*xs, jnp.zeros((B, di, n), jnp.float32),
                                chunk=64)
        return jnp.sum(y * dy) + (0.0 if dh is None else jnp.sum(h * dh))
    want = jax.grad(jax_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))

    def gaps(ref_grads):
        return [float(np.abs(g.numpy() - np.asarray(w)).max()
                      / np.abs(np.asarray(w)).max())
                for g, w in zip(got, ref_grads)]
    return gaps([p.detach() for p in plain]), gaps(want)


@pytest.mark.parametrize("shape", BWD_ORDER_SHAPES, ids=str)
def test_backward_kernel_order_matches_plain_gradients_and_jax_grad(shape):
    """The backward kernel's chunk split (L_k + P_k r_k), lane split and
    channel-sum tree hold the gradients of the plain version and of
    jax.grad of the model scan before they reach the card."""
    plain, jax_gaps = bwd_order_gaps(shape)
    assert max(plain) <= RTOL_BWD_ORDER, plain
    assert max(jax_gaps) <= RTOL_BWD_ORDER, jax_gaps


if __name__ == "__main__":
    print("backward kernel order vs plain gradients and jax.grad, worst "
          "of the six: " + ", ".join(
              f"{s}: {max(max(g) for g in bwd_order_gaps(s)):.2e}"
              for s in BWD_ORDER_SHAPES) + f" (RTOL {RTOL_BWD_ORDER})")
    print("gradients vs jax.grad of the model scan, worst of the six: "
          f"{max(max(scan_grad_gaps(s)) for s in GRAD_SHAPES):.2e} "
          f"(RTOL_GRAD {RTOL_GRAD})")
    worst_y = worst_h = 0.0
    for shape in [(1, 128, 256, 16), (2, 256, 512, 8), (1, 64, 1024, 16),
                  (2, 45, 200, 8), (1, 37, 3200, 16), (3, 130, 96, 4)]:
        arrays = _inputs(*shape, 2)
        y, h = _port(arrays)
        y_ref, h_ref = _jax_ref(arrays)
        worst_y = max(worst_y, float(np.abs(y - np.asarray(y_ref)).max()))
        worst_h = max(worst_h, float(np.abs(h - np.asarray(h_ref)).max()))
        if shape[1] % min(64, shape[1]) == 0 and shape[2] % 256 == 0:
            pallas = ssm_scan_pallas(*(jnp.asarray(a) for a in arrays),
                                     block_d=256, chunk=min(64, shape[1]),
                                     interpret=True)
            worst_y = max(worst_y,
                          float(np.abs(y - np.asarray(pallas)).max()))
    print(f"plain version vs Pallas kernel and oracle, max abs err: y "
          f"{worst_y:.3e}, h_final {worst_h:.3e}")
    for exp2 in (True, False):
        for group in (2, 4, 8):
            gaps = []
            for shape in MIRROR_SHAPES:
                arrays = _inputs(*shape, 8)
                y, h = _kernel_order(*(torch.from_numpy(a) for a in arrays),
                                     group, exp2)
                y_plain, h_plain = _port(arrays)
                gaps += [float(np.abs(y.numpy() - y_plain).max()),
                         float(np.abs(h.numpy() - h_plain).max())]
            print(f"kernel order, {group} lanes, "
                  f"{'exp2' if exp2 else 'exp'}: max abs err vs plain "
                  f"{max(gaps):.3e}")
