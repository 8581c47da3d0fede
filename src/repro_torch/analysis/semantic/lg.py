"""LG: the launch verifier of the port's CUDA kernels (semantic tier).

The counterpart of the JAX package's PB, which proves BlockSpec windows
over the whole grid. CUDA has no BlockSpec to enumerate, so the proof
splits in two:

LG01  (static, CPU) at every shape profile the wrapper accepts, each launch
      the library makes stays inside Hopper's limits: grid x <= 2^31 - 1,
      y and z <= 65,535, <= 1,024 threads, dynamic shared memory <= the
      227 KB opt-in (static <= 48 KB), every size the ``.cu`` holds in a
      32-bit ``int`` below 2^31 and every packed field inside its bits. The
      geometry is a model of each library's launch function, built on the
      constants it parses from ``csrc/`` (``cu_constants``). The profiles:
      the serving and training shapes of all 10 configs and of their
      reduced versions, the dry-run shape cells (``long_500k`` included),
      ragged S, and each guard's limit (``static_profiles``). A shape the
      wrapper refuses (its own guard raises), or the launch function
      refuses before its first launch (``launch_refuses``: the attention
      backward's grids past ``kMaxGridY`` on y), is counted, not checked.
LG02  (card) an output element still holds the sentinel: never written.
LG03  (card) a guard band or an input changed, or an output is NaN where
      the plain version's is finite (a read past an operand met its NaN
      guard band).
LG04  (card) two launches on the same inputs are not bit-equal where the
      library is declared deterministic (``DETERMINISTIC``).
LG05  (static; on the card also for every route ``capture`` saw launched)
      a library of ``LAUNCH_ARGTYPES``, a (D, Dv) pair of ``HEAD_DIM_PAIRS``
      / ``WGMMA_FWD_PAIRS`` / ``WGMMA_PAIRS`` / ``WGMMA_BWD_ONE``, or an
      instantiation in ``csrc/*.cu`` without a card profile, or a constant
      the model needs that the sources no longer define.

On the card (``check_card``) each card profile calls ``<name>_launch``
directly, in ``LAUNCH_ARGTYPES`` order, with pointers into one allocation
per operand that holds the operand between two guard bands of at least
64 KB. Outputs, ``lse`` and scratch (exactly ``scratch_floats`` long)
start as a NaN payload no arithmetic makes (``SENTINEL``), compared by bit
pattern; the inputs' guard bands hold NaN.
"""
from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.findings import Finding

CSRC = "src/repro_torch/kernels/csrc"
WRAPPERS = {
    "retention": "src/repro_torch/kernels/retention.py",
    "ssm_scan": "src/repro_torch/kernels/ssm_scan.py",
    "ssm_scan_bwd": "src/repro_torch/kernels/ssm_scan.py",
    "flash_attention": "src/repro_torch/kernels/flash_attention.py",
    "flash_attention_bwd": "src/repro_torch/kernels/flash_attention.py",
}
# Hopper's launch limits
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_THREADS = 1024
MAX_DYNAMIC_SMEM = 227 * 1024       # the opt-in maximum a block
MAX_STATIC_SMEM = 48 * 1024
INT32_MAX = 2 ** 31 - 1
# every library's writes are the same bits on the same inputs: no atomics,
# no order of blocks in any sum
DETERMINISTIC = frozenset({"retention", "ssm_scan", "ssm_scan_bwd",
                           "flash_attention", "flash_attention_bwd"})

# the constants the geometry model reads from each source
NEEDED = {
    "retention.cu": ("kBlock",),
    "ssm_scan.cuh": ("kGroup", "kThreads", "kStateEvery"),
    "ssm_scan.cu": ("kChunk",),
    "ssm_scan_bwd.cu": ("kLogG3", "kThreads3", "kWarps3"),
    "flash_attention.cuh": ("kBQ", "kBQWG", "kBK", "kWarps", "kThreadsTC",
                            "kPad"),
    "wgmma.cuh": ("kTileBytes",),
    "flash_attention.cu": ("kThreadsF",),
    "flash_attention_bwd.cu": ("kSlots", "kSumHeadsBlocks", "kMaxGridY"),
}
_CONST = re.compile(r"^\s*constexpr\s+(?:int|long long)\s+([^;(]+);", re.M)
# the sub-chunk of steps of ssm_scan_bwd.cu's Grad<N> (a struct member, not
# a namespace constant)
_GRAD_U = re.compile(r"static constexpr int U = (\d+);")
_PAIR_INST = re.compile(r"launch<(\d+), (\d+)>\(")
_N_INST = re.compile(r"launch<(\d+)>\(")


def cu_constants(root) -> Tuple[Dict[str, int], List[str]]:
    """The constants ``NEEDED`` names, evaluated from the sources' own
    ``constexpr`` lines; and the names not found (spec rot)."""
    out: Dict[str, int] = {}
    missing: List[str] = []
    base = Path(root) / CSRC
    for fname, names in NEEDED.items():
        path = base / fname
        text = path.read_text(encoding="utf-8") if path.is_file() else ""
        found: Dict[str, str] = {}
        for decls in _CONST.findall(text):        # "a = 1, b = a / 2"
            for decl in decls.split(","):
                name, _, expr = decl.partition("=")
                found[name.strip()] = expr.strip()
        scope: Dict[str, int] = {}
        for name, expr in found.items():
            expr = re.sub(r"(\d+)LL\b", r"\1", expr).replace("/", "//")
            try:
                scope[name] = int(eval(expr, {"__builtins__": {}}, scope))
            except (NameError, SyntaxError, TypeError):
                continue        # not an integer expression of the file's own
        for name in names:
            if name in scope:
                out[name] = scope[name]
            else:
                missing.append(f"{fname}:{name}")
        if fname == "ssm_scan_bwd.cu":
            m = _GRAD_U.search(text)
            if m is None:
                missing.append(f"{fname}:Grad::U")
            else:
                out["kGradU"] = int(m.group(1))
    return out, missing


def instantiations(root) -> Dict[str, set]:
    """The explicit instantiations each library's C entry point dispatches
    to: (D, Dv) pairs of the attention libraries, n of the scans."""
    out = {}
    base = Path(root) / CSRC
    for lib in ("flash_attention", "flash_attention_bwd"):
        text = (base / f"{lib}.cu").read_text(encoding="utf-8")
        out[lib] = {(int(a), int(b)) for a, b in _PAIR_INST.findall(
            text[text.find(f'extern "C" int {lib}_launch'):])}
    for lib in ("ssm_scan", "ssm_scan_bwd"):
        text = (base / f"{lib}.cu").read_text(encoding="utf-8")
        out[lib] = {int(n) for n in _N_INST.findall(
            text[text.find(f'extern "C" int {lib}_launch'):])}
    return out


# ---------------------------------------------------------------------------
# the geometry model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Launch:
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int = 0                   # dynamic shared memory [bytes]
    static_smem: int = 0            # static shared memory [bytes]
    ints: Dict[str, int] = dataclasses.field(default_factory=dict)
    packed: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)       # label -> (value, most it may hold)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _attention_kind(D: int, Dv: int, bf16: bool, backward: bool) -> str:
    from repro_torch.kernels import flash_attention as kflash
    if not bf16:
        return "f32"
    if backward:
        return ("wg2" if (D, Dv) in kflash.WGMMA_PAIRS else
                "wg" if (D, Dv) in kflash.WGMMA_BWD_ONE else "tc")
    return "wg" if (D, Dv) in kflash.WGMMA_FWD_PAIRS else "tc"


def geometry(lib: str, s: dict, C: Dict[str, int]) -> List[Launch]:
    """Every launch ``<lib>_launch`` makes at shape ``s`` (the launch's own
    integer arguments), as the library's launch function computes it."""
    if lib == "retention":
        return [Launch("retention_kernel", (_cdiv(s["B"], C["kBlock"]), 1, 1),
                       C["kBlock"], smem=(4 * s["n_steps"] + 1) * 4,
                       ints={"n_steps": s["n_steps"]})]
    if lib == "ssm_scan":
        N, CH = s["n"], C["kThreads"] // C["kGroup"]
        stage = 4 * (2 * C["kChunk"] * CH + 2 * C["kChunk"] * N)
        return [Launch(f"ssm_scan_kernel<{N}>",
                       (_cdiv(s["di"], CH), s["B"], 1), C["kThreads"],
                       static_smem=2 * stage,
                       ints={k: s[k] for k in ("B", "S", "di", "n")})]
    if lib == "ssm_scan_bwd":
        N, B, S, di = s["n"], s["B"], s["S"], s["di"]
        kT, T3 = C["kStateEvery"], C["kThreads3"]
        G3 = 1 << C["kLogG3"]
        CH, NL, U = T3 // G3, N // G3, C["kGradU"]
        K, nblk = _cdiv(S, kT), _cdiv(di, T3 // G3)
        smem = 4 * (3 * kT * CH + 2 * kT * N + (kT // U) * T3 * NL
                    + 4 * C["kWarps3"] * U * N)
        ints = {"B": B, "S": S, "di": di, "n": N, "B*K": B * K}
        out = []
        if K > 1:
            out.append(Launch(f"ssm_scan_bwd_chunk_adjoint<{N}>",
                              (nblk, K - 1, B), C["kThreads"], ints=ints))
        total = 2 * B * S * N + di * N + di
        out += [Launch("ssm_scan_bwd_carries", (_cdiv(B * di * N, 256), 1, 1),
                       256, ints=ints),
                Launch(f"ssm_scan_bwd_grads<{N}>", (nblk, K, B), T3,
                       smem=smem, ints=ints),
                Launch("ssm_scan_bwd_reduce",
                       (min(_cdiv(total, 256), 4096), 1, 1), 256, ints=ints)]
        return out
    B, H, K, S, Sk, D, Dv = (s[k] for k in ("B", "H", "K", "S", "Sk", "D",
                                            "Dv"))
    bf16 = bool(s["bf16"])
    ints = {"B": B, "H": H, "K": K, "S": S, "Sk": Sk, "D": D, "Dv": Dv,
            "B*H": B * H}
    kBQ, kBK, TC, pad = C["kBQ"], C["kBK"], C["kThreadsTC"], C["kPad"]
    n_qt, n_kt = _cdiv(S, kBQ), _cdiv(Sk, kBK)
    if lib == "flash_attention":
        kind = _attention_kind(D, Dv, bf16, backward=False)
        if kind == "f32":
            smem = 4 * (kBQ * (D + 1) + kBK * (D + 1) + kBK * Dv
                        + kBQ * (kBK + 1))
            return [Launch(f"flash_kernel_f32<{D},{Dv}>", (n_qt, B * H, 1),
                           C["kThreadsF"], smem=smem, ints=ints)]
        if kind == "wg":
            W = 64 if D % 64 == 0 and Dv % 64 == 0 else 32
            NQ, NV, NC, slots = _cdiv(D, W), _cdiv(Dv, W), 2, 4
            smem = (NC * NQ + slots * (NQ + NV)) * (64 * 2 * W) + 1024
            return [Launch(f"flash_kernel_wg<{D},{Dv}>",
                           (_cdiv(S, 64 * NC), B * H, 1), (NC + 1) * TC,
                           smem=smem, ints=ints)]
        smem = 2 * ((D + pad) * (kBQ + 2 * kBK) + (Dv + pad) * 2 * kBK)
        return [Launch(f"flash_kernel_tc<{D},{Dv}>", (n_qt, B * H, 1), TC,
                       smem=smem, ints=ints)]
    # flash_attention_bwd
    kind = _attention_kind(D, Dv, bf16, backward=True)
    rows = B * H * S
    G = H // K
    if kind == "f32":
        kv = 4 * (2 * kBK * (D + 1) + 2 * kBK * (Dv + 1) + 2 * kBQ
                  + 2 * kBK * (kBQ + 1))
        q = 4 * (2 * kBK * (D + 1) + 2 * kBK * (Dv + 1) + kBQ * (kBK + 1))
        ints = dict(ints, **{"G*n_qt": G * n_qt})
        return [Launch("delta_kernel", (_cdiv(rows, 8), 1, 1), 256, ints=ints),
                Launch(f"dkdv_kernel_f32<{D},{Dv}>", (n_kt, B * K, 1),
                       C["kThreadsF"], smem=kv, ints=ints),
                Launch(f"dq_kernel_f32<{D},{Dv}>", (n_qt, B * H, 1),
                       C["kThreadsF"], smem=q, ints=ints)]
    out = [Launch(f"delta_kernel_bf16<{Dv}>", (_cdiv(rows, 32), 1, 1), 256,
                  ints=ints)]
    n4 = B * K * Sk * (D if D == Dv else D + Dv) // 4
    combine_rows = _cdiv(_cdiv(n4, 8 * TC), B * H)
    if kind == "wg2":
        nh = G if B * K * n_kt >= C["kSumHeadsBlocks"] else 1
        tile = C["kTileBytes"]
        smem = ((1 + C["kSlots"]) * (D + Dv) // 64 * tile
                + 4 * (2 * kBQ * kBK + 2 * C["kSlots"] * kBQ) + 1024)
        n_combine = 0 if nh == G else _cdiv(n4, 8 * TC)
        ints = dict(ints, **{"n_kt*B*H": n_kt * B * H})
        packed = {"q tile of an item (it & 0xFFFF)": (n_qt - 1, 0xFFFF),
                  "head of an item (it >> 16)": (nh - 1, 2 ** 15 - 1)}
        return out + [
            Launch(f"dkdv_kernel_wg2<{D},{Dv}>", (n_kt * B * H // nh, 1, 1),
                   2 * TC, smem=smem, ints=ints, packed=packed),
            Launch(f"dq_kernel_wg2<{D},{Dv}>",
                   (n_qt * B * H + n_combine, 1, 1), 2 * TC, smem=smem,
                   ints=ints)]
    if kind == "wg":
        smem = 6 * C["kTileBytes"] + 4 * 4 * kBQ + 1024
        kv_smem = q_smem = smem
    else:
        kv_smem = 2 * ((D + pad) + (Dv + pad)) * (kBK + 2 * kBQ) + 4 * 4 * kBQ
        q_smem = 2 * ((D + pad) + (Dv + pad)) * (kBQ + 2 * kBK)
    return out + [
        Launch(f"dkdv_kernel_{kind}<{D},{Dv}>", (B * H, n_kt, 1), TC,
               smem=kv_smem, ints=ints),
        Launch(f"dq_kernel_{kind}<{D},{Dv}>", (B * H, n_qt + combine_rows, 1),
               TC, smem=q_smem, ints=ints)]


def limits_broken(launch: Launch) -> List[str]:
    """What of Hopper's limits (and the .cu's integer types) a launch
    breaks."""
    x, y, z = launch.grid
    out = []
    if x > MAX_GRID_X:
        out.append(f"grid x {x} > {MAX_GRID_X}")
    for axis, v in (("y", y), ("z", z)):
        if v > MAX_GRID_YZ:
            out.append(f"grid {axis} {v} > {MAX_GRID_YZ}")
    if launch.threads > MAX_THREADS:
        out.append(f"{launch.threads} threads > {MAX_THREADS}")
    if launch.smem > MAX_DYNAMIC_SMEM:
        out.append(f"dynamic shared memory {launch.smem} B > "
                   f"{MAX_DYNAMIC_SMEM}")
    if launch.static_smem > MAX_STATIC_SMEM:
        out.append(f"static shared memory {launch.static_smem} B > "
                   f"{MAX_STATIC_SMEM}")
    for label, v in launch.ints.items():
        if v > INT32_MAX:
            out.append(f"int {label} = {v} > {INT32_MAX}")
    for label, (v, most) in launch.packed.items():
        if v > most:
            out.append(f"{label} = {v} > {most}")
    return out


# ---------------------------------------------------------------------------
# static shape profiles (LG01)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeProfile:
    label: str
    lib: str
    shape: Tuple[Tuple[str, int], ...]      # the launch's integer arguments

    @property
    def s(self) -> dict:
        return dict(self.shape)


def _attn_shape(B, H, K, S, D, Dv, bf16):
    from repro_torch.kernels import flash_attention as kflash
    return (("B", B), ("H", H), ("K", K), ("S", S), ("Sk", S),
            ("D", kflash.kernel_dim(D, Dv)), ("Dv", Dv), ("bf16", int(bf16)))


def _attn_dims(cfg):
    if cfg.mla:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def static_profiles() -> List[ShapeProfile]:
    """LG01's profiles: every config's (and its reduced version's) serving
    and training shapes, the dry-run shape cells, ragged S, the retention
    grids, and each wrapper guard's limit and one past it."""
    from repro_torch.configs import base as cbase
    from repro_torch.core import retention as ret
    from repro_torch.kernels import retention as kret
    out: List[ShapeProfile] = []

    def attn(label, cfg, B, S, train, dtypes):
        D, Dv = _attn_dims(cfg)
        for bf16 in dtypes:
            shape = _attn_shape(B, cfg.num_heads, cfg.num_kv_heads, S, D, Dv,
                                bf16)
            tag = f"{label}:{'bf16' if bf16 else 'f32'}"
            out.append(ShapeProfile(tag, "flash_attention", shape))
            if train:
                out.append(ShapeProfile(tag, "flash_attention_bwd", shape))

    def scan(label, cfg, B, S, train):
        shape = (("B", B), ("S", S), ("di", cfg.d_model * cfg.ssm_expand),
                 ("n", cfg.ssm_state))
        out.append(ShapeProfile(label, "ssm_scan", shape))
        if train:
            out.append(ShapeProfile(label, "ssm_scan_bwd", shape))

    for arch in cbase.list_archs():
        full = cbase.get_config(arch)
        for cfg, tag in ((full, arch), (cbase.reduce_config(full),
                                        f"{arch}/reduced")):
            cells = [(f"{tag}:serve", 4, 1000, False),
                     (f"{tag}:train", 4, 1128, True)]
            cells += [(f"{tag}:ragged{S}", 2, S, True) for S in (1, 65, 333)]
            cells += [(f"{tag}:{c.name}", c.global_batch, c.seq_len,
                       c.kind == "train")
                      for c in cbase.applicable_shapes(cfg)]
            for label, B, S, train in cells:
                if cfg.family != "ssm":
                    attn(label, cfg, B, S, train, (False, True))
                if cfg.ssm_state and cfg.family == "hybrid":
                    scan(label, cfg, B, S, train)
    # each guard at its limit and one past it
    for y in (65535, 65536):
        for bf16 in (False, True):
            shape = _attn_shape(y, 1, 1, 64, 64, 64, bf16)
            out += [ShapeProfile(f"limit:B*H={y}", lib, shape)
                    for lib in ("flash_attention", "flash_attention_bwd")]
    # the bf16 backward's y axes: D = 64's query tiles plus the combine's
    # rows (65,534 and 65,536), and the two-warpgroup pair's packed q tile
    for S, D in ((64 * 32767, 64), (64 * 32768, 64), (64 * 65536, 128),
                 (64 * 65536 + 1, 128)):
        shape = _attn_shape(1, 1, 1, S, D, D, True)
        out.append(ShapeProfile(f"limit:S={S},D={D}", "flash_attention_bwd",
                                shape))
    for B, S in ((65535, 64), (65536, 64), (1, 64 * 65535),
                 (1, 64 * 65535 + 1)):
        shape = (("B", B), ("S", S), ("di", 3200), ("n", 16))
        out += [ShapeProfile(f"limit:B={B},S={S}", lib, shape)
                for lib in ("ssm_scan", "ssm_scan_bwd")]
    n_steps = ret.N_STEPS
    for B in (1, 120, 2809, 2 ** 20, 2 ** 31):
        out.append(ShapeProfile(f"retention:B={B}", "retention",
                                (("B", B), ("n_steps", n_steps))))
    for points in (kret._MAX_GRID_POINTS, kret._MAX_GRID_POINTS + 1):
        out.append(ShapeProfile(f"limit:ts={points}", "retention",
                                (("B", 120), ("n_steps", points - 1))))
    return out


def wrapper_accepts(p: ShapeProfile) -> bool:
    """Whether the library's wrapper takes this shape (its guards do not
    raise)."""
    import torch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import retention as kret
    from repro_torch.kernels import ssm_scan as kssm
    s = p.s
    try:
        if p.lib == "retention":
            meta = torch.device("meta")
            kret._check(torch.empty((s["B"], kret.N_FIELDS), device=meta),
                        torch.empty((s["n_steps"] + 1,), device=meta))
        elif p.lib.startswith("ssm_scan"):
            if s["n"] not in kssm.STATE_SIZES:
                return False
            kssm._check_grid(s["B"], s["S"] if p.lib == "ssm_scan_bwd"
                             else 0)
        else:
            dtype = torch.bfloat16 if s["bf16"] else torch.float32
            kflash._check_grid(s["B"], s["H"], s["S"], s["D"], s["Dv"],
                               dtype, backward=p.lib == "flash_attention_bwd")
    except ValueError:
        return False
    return True


def launch_refuses(lib: str, launches: Sequence[Launch],
                   C: Dict[str, int]) -> bool:
    """Whether the library's launch function refuses the shape before its
    first launch: the attention backward's returns
    cudaErrorInvalidConfiguration where a grid's y axis would take more
    than ``kMaxGridY`` blocks."""
    return lib == "flash_attention_bwd" and any(
        launch.grid[1] > C["kMaxGridY"] for launch in launches)


def check_static(project) -> Tuple[List[Finding], dict]:
    """LG01 over ``static_profiles`` and LG05's static half. Returns the
    findings and counts (profiles checked, refused by a guard, launches)."""
    root = project.root
    findings: List[Finding] = []
    C, missing = cu_constants(root)
    for name in missing:
        findings.append(Finding("LG05", CSRC, 0, f"constant {name} the "
                                f"launch model reads is gone", snippet=name))
    findings += _check_spec(project)
    stats = {"profiles": 0, "refused": 0, "launches": 0}
    if missing:
        return findings, stats
    for p in static_profiles():
        launches = geometry(p.lib, p.s, C)
        if not wrapper_accepts(p) or launch_refuses(p.lib, launches, C):
            stats["refused"] += 1
            continue
        stats["profiles"] += 1
        for launch in launches:
            stats["launches"] += 1
            broken = limits_broken(launch)
            if broken:
                findings.append(Finding(
                    "LG01", WRAPPERS[p.lib], 0,
                    f"{p.lib} at {p.label} {p.s}: {launch.kernel} "
                    f"{'; '.join(broken)}, and neither the wrapper nor the "
                    f"launch function refuses the shape", snippet=f"{launch.kernel}@{p.label}"))
    return list(dict.fromkeys(findings)), stats


# ---------------------------------------------------------------------------
# routes: which code path of a library a launch takes
# ---------------------------------------------------------------------------


def route(lib: str, s: dict) -> str:
    """The route a launch at shape ``s`` takes through ``lib``: the kernel
    (and the branch the launch function picks) it runs. ``s`` holds the
    launch's integer arguments and which optional pointers are set."""
    if lib == "retention":
        return "retention_kernel"
    if lib == "ssm_scan":
        return f"ssm_scan_kernel<{s['n']}>" + (":states" if s["states"]
                                               else "")
    if lib == "ssm_scan_bwd":
        return f"ssm_scan_bwd<{s['n']}>" + (":dh_final" if s["dh_final"]
                                            else "")
    D, Dv, bf16 = s["D"], s["Dv"], bool(s["bf16"])
    if lib == "flash_attention":
        kind = _attention_kind(D, Dv, bf16, backward=False)
        mode = "" if not bf16 else (":p_rounded" if s["round_p"]
                                    else ":p_f32")
        return (f"flash_kernel_{kind}<{D},{Dv}>{mode}"
                + (":lse" if s["lse"] else ""))
    kind = _attention_kind(D, Dv, bf16, backward=True)
    if kind == "f32":
        branch = ""
    elif kind != "wg2":
        branch = ":partials"
    else:
        branch = _wg2_branch(s)
    return f"dkdv_kernel_{kind}<{D},{Dv}>{branch}"


def _wg2_branch(s: dict) -> str:
    """The two-warpgroup pair's branch, as ``backward_heads_per_block``
    decides it: one head a kv head (direct), a dK/dV block summing the
    kv head's G heads, or per-head partials and the combine."""
    import torch
    from repro_torch.kernels import flash_attention as kflash
    if s["H"] == s["K"]:
        return ":direct"
    nh = kflash.backward_heads_per_block(s["B"], s["H"], s["K"], s["Sk"],
                                         s["D"], s["Dv"], torch.bfloat16)
    return ":sum" if nh > 1 else ":partials"


def required_routes() -> Dict[str, set]:
    """Every route the libraries' instantiations and branches make: each
    must have a card profile (LG05)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssm_scan as kssm
    out = {"retention": {"retention_kernel"},
           "ssm_scan": set(), "ssm_scan_bwd": set(),
           "flash_attention": set(), "flash_attention_bwd": set()}
    for n in kssm.STATE_SIZES:
        out["ssm_scan"] |= {route("ssm_scan", {"n": n, "states": st})
                            for st in (0, 1)}
        out["ssm_scan_bwd"] |= {route("ssm_scan_bwd", {"n": n, "dh_final": d})
                                for d in (0, 1)}
    for D, Dv in kflash.HEAD_DIM_PAIRS:
        base = {"D": D, "Dv": Dv}
        fwd = [dict(base, bf16=0, round_p=0, lse=lse) for lse in (0, 1)]
        fwd += [dict(base, bf16=1, round_p=1, lse=0),
                dict(base, bf16=1, round_p=0, lse=0),
                dict(base, bf16=1, round_p=0, lse=1)]
        out["flash_attention"] |= {route("flash_attention", s) for s in fwd}
        out["flash_attention_bwd"].add(
            route("flash_attention_bwd", dict(base, bf16=0)))
        if _attention_kind(D, Dv, True, backward=True) == "wg2":
            out["flash_attention_bwd"] |= {
                f"dkdv_kernel_wg2<{D},{Dv}>:{b}"
                for b in ("sum", "partials", "direct")}
        else:
            out["flash_attention_bwd"].add(
                route("flash_attention_bwd", dict(base, bf16=1)))
    return out


# ---------------------------------------------------------------------------
# card profiles (LG02-LG04)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CardProfile:
    label: str
    lib: str
    shape: Tuple[Tuple[str, int], ...]

    @property
    def s(self) -> dict:
        return dict(self.shape)

    @property
    def route(self) -> str:
        return route(self.lib, self.s)


def card_profiles() -> List[CardProfile]:
    """The card's guarded launches: retention at B = 1, 120 and 2,809; the
    scans at ragged S and a di no block divides, every n; every forward
    (D, Dv) x dtype x p x lse at S in {1, 65, 333} with MHA, MQA and GQA
    with a window and a sink; every backward route, the two-warpgroup pairs
    on the summed-heads, partials-plus-combine and one-head branches."""
    from repro_torch.core import retention as ret
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssm_scan as kssm
    out: List[CardProfile] = []
    for B in (1, 120, 2809):
        out.append(CardProfile(f"B={B}", "retention",
                               (("B", B), ("n_steps", ret.N_STEPS))))
    for n in kssm.STATE_SIZES:
        for S, di, st in ((65, 200, 1), (333, 96, 0), (1, 40, 1),
                          (193, 72, 0)):
            out.append(CardProfile(
                f"n={n},S={S},di={di}", "ssm_scan",
                (("B", 2), ("S", S), ("di", di), ("n", n), ("states", st))))
        for S, di, d in ((65, 200, 1), (193, 72, 0), (1, 40, 1)):
            out.append(CardProfile(
                f"n={n},S={S},di={di}", "ssm_scan_bwd",
                (("B", 2), ("S", S), ("di", di), ("n", n), ("dh_final", d))))
    # (B, H, K, S, window, sink): MHA, MQA, GQA with a window and a sink
    heads = ((2, 2, 2, 1, 0, 0), (1, 3, 1, 65, 0, 0), (2, 4, 2, 333, 40, 3))
    for D, Dv in kflash.HEAD_DIM_PAIRS:
        modes = [(0, 0, lse) for lse in (0, 1)] + [(1, 1, 0), (1, 0, 0),
                                                   (1, 0, 1)]
        for bf16, round_p, lse in modes:
            for B, H, K, S, window, sink in heads:
                out.append(CardProfile(
                    f"D={D},Dv={Dv},S={S},H={H},K={K}", "flash_attention",
                    (("B", B), ("H", H), ("K", K), ("S", S), ("Sk", S),
                     ("D", D), ("Dv", Dv), ("bf16", bf16), ("causal", 1),
                     ("window", window), ("sink", sink),
                     ("round_p", round_p), ("lse", lse))))
        bwd = [(0, 2, 4, 2, 333, 40, 3), (0, 1, 3, 1, 65, 0, 0),
               (1, 2, 4, 2, 333, 40, 3), (1, 1, 3, 1, 65, 0, 0),
               (1, 2, 2, 2, 70, 0, 0)]
        if (D, Dv) in kflash.WGMMA_PAIRS:
            # B K ceil(Sk / 64) = SUM_HEADS_BLOCKS: a dK/dV block sums its
            # kv head's heads
            bwd.append((1, 4, 8, 4, 64 * kflash.SUM_HEADS_BLOCKS // 16, 0, 0))
        for bf16, B, H, K, S, window, sink in bwd:
            out.append(CardProfile(
                f"D={D},Dv={Dv},S={S},H={H},K={K}", "flash_attention_bwd",
                (("B", B), ("H", H), ("K", K), ("S", S), ("Sk", S),
                 ("D", D), ("Dv", Dv), ("bf16", bf16), ("causal", 1),
                 ("window", window), ("sink", sink))))
    return out


def _check_spec(project) -> List[Finding]:
    """LG05's static half: every library, (D, Dv) pair, instantiation and
    route has a card profile."""
    from repro_torch.analysis import kernel_cov
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssm_scan as kssm
    findings = []

    def rot(rel, what):
        findings.append(Finding("LG05", rel, 0, what, snippet=what))

    profiled: Dict[str, set] = {}
    for p in card_profiles():
        profiled.setdefault(p.lib, set()).add(p.route)
    libs, _ = kernel_cov.libraries(project)
    for lib in libs:
        if lib not in profiled:
            rot(kernel_cov.BUILD_REL, f"library {lib} has no card profile")
    attn = "src/repro_torch/kernels/flash_attention.py"
    pairs = set(kflash.HEAD_DIM_PAIRS)
    for name in ("WGMMA_FWD_PAIRS", "WGMMA_PAIRS", "WGMMA_BWD_ONE"):
        for pair in set(getattr(kflash, name)) - pairs:
            rot(attn, f"{name} pair {pair} is not in HEAD_DIM_PAIRS")
    inst = instantiations(project.root)
    for lib in ("flash_attention", "flash_attention_bwd"):
        for pair in inst[lib] ^ pairs:
            rot(f"{CSRC}/{lib}.cu", f"{lib}.cu instantiates {sorted(inst[lib])}"
                f", HEAD_DIM_PAIRS has {sorted(pairs)}: {pair} differs")
    for lib in ("ssm_scan", "ssm_scan_bwd"):
        for n in inst[lib] ^ set(kssm.STATE_SIZES):
            rot(f"{CSRC}/{lib}.cu", f"{lib}.cu instantiates "
                f"{sorted(inst[lib])}, STATE_SIZES is {kssm.STATE_SIZES}: "
                f"n = {n} differs")
    for lib, routes in required_routes().items():
        for r in sorted(routes - profiled.get(lib, set())):
            rot(WRAPPERS[lib], f"route {lib}:{r} has no card profile")
    return findings


def check_routes_seen(seen: Sequence[Tuple[str, str, str, int]]
                      ) -> List[Finding]:
    """LG05 on the card: a route ``capture`` saw launched (library, route,
    call-site path, line) with no card profile."""
    profiled = {(p.lib, p.route) for p in card_profiles()}
    return list(dict.fromkeys(
        Finding("LG05", path, line, f"{lib} launched on route {r} with no "
                f"card profile", snippet=f"{lib}:{r}")
        for lib, r, path, line in seen if (lib, r) not in profiled))


# ---------------------------------------------------------------------------
# the card half
# ---------------------------------------------------------------------------

GUARD_BYTES = 64 * 1024
# NaN payloads no arithmetic makes (the card's own NaNs are 0x7FFFFFFF and
# 0x7FFF): quiet bit clear
SENTINEL = {"float32": 0x7FA5A5A5, "bfloat16": 0x7FA5}


class Guarded:
    """One allocation holding an operand between two guard bands."""

    def __init__(self, numel: int, dtype, device, fill: str, data=None):
        import torch
        self.dtype = dtype
        item = torch.empty((), dtype=dtype).element_size()
        self.guard = max(GUARD_BYTES // item, 1)
        self.numel = numel
        self.buf = torch.empty(numel + 2 * self.guard, dtype=dtype,
                               device=device)
        self.fill = fill
        self.reset()
        if data is not None:
            self.interior.copy_(data.reshape(-1))
        self.before = self.bits().clone()

    @property
    def interior(self):
        return self.buf[self.guard:self.guard + self.numel]

    def ptr(self) -> int:
        return self.interior.data_ptr()

    def bits(self):
        import torch
        view = torch.int32 if self.buf.element_size() == 4 else torch.int16
        return self.buf.view(view)

    def reset(self) -> None:
        """Fill everything with the sentinel (outputs) or NaN (inputs)."""
        if self.fill == "sentinel":
            self.bits().fill_(self.sentinel)
        else:
            self.buf.fill_(float("nan"))

    @property
    def sentinel(self) -> int:
        return SENTINEL[str(self.dtype).removeprefix("torch.")]

    def guards_changed(self) -> bool:
        import torch
        b, a = self.bits(), self.before
        g = self.guard
        return not (torch.equal(b[:g], a[:g]) and torch.equal(b[-g:], a[-g:]))

    def interior_changed(self) -> bool:
        import torch
        g = self.guard
        return not torch.equal(self.bits()[g:g + self.numel],
                               self.before[g:g + self.numel])

    def unwritten(self) -> int:
        g = self.guard
        return int((self.bits()[g:g + self.numel] == self.sentinel).sum())


def _inputs(p: CardProfile, device, seed: int):
    """(operands, plain outputs, output specs, launch-argument builder) of
    one card profile."""
    import torch
    from repro_torch.core import bitcells, retention as ret
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    from repro_torch.kernels import retention as kret
    from repro_torch.kernels import ssm_scan as kssm
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = p.s

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device,
                                                    dtype=dtype)

    if p.lib == "retention":
        cells = bitcells.stack_bitcells()
        base = torch.cat([ret.pack_retention_params(
            cells, torch.full((len(bitcells.MEM_TYPE_ORDER),), float(ls)))
            for ls in (0, 1)])
        rows = base[torch.arange(s["B"]) % base.shape[0]].clone()
        rows[:, 2] *= 10.0 ** (torch.rand(s["B"], generator=g) * 2 - 1)
        params = rows.to(device)
        ts = ret.time_grid(device)
        ut32, inv_ut32 = kret.thermal_voltage_args(kret.UT)
        ins = {"params_t": params.t().contiguous(), "ts": ts}
        want = {"out": ref.retention_ref(params, ts, ut32)}
        outs = {"out": ((s["B"],), torch.float32)}

        def args(P):
            return (P["params_t"], P["ts"], P["out"], s["B"], s["n_steps"],
                    ut32, inv_ut32)
        return ins, want, outs, {}, args
    if p.lib in ("ssm_scan", "ssm_scan_bwd"):
        B, S, di, n = s["B"], s["S"], s["di"], s["n"]
        x = randn(B, S, di)
        dt = torch.nn.functional.softplus(randn(B, S, di)) * 0.1
        A = -torch.exp(randn(di, n) * 0.5)
        Bc, Cc, D = randn(B, S, n), randn(B, S, n), randn(di)
        ins = {"x": x, "dt": dt, "A": A, "Bc": Bc, "Cc": Cc, "D": D}
        if p.lib == "ssm_scan":
            y, h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D)
            want = {"y": y, "h_final": h}
            outs = {"y": ((B, S, di), torch.float32),
                    "h_final": ((B, di, n), torch.float32)}
            if s["states"]:
                outs["states"] = ((B, _cdiv(S, kssm.STATE_EVERY), di, n),
                                  torch.float32)

            def args(P):
                return (P["x"], P["dt"], P["A"], P["Bc"], P["Cc"], P["D"],
                        P["y"], P["h_final"], P.get("states", 0), B, S, di, n)
            return ins, want, outs, {}, args
        _, _, states = kssm._forward(x, dt, A, Bc, Cc, D, with_states=True)
        dy = randn(B, S, di)
        dh = randn(B, di, n) if s["dh_final"] else None
        ins.update(states=states, dy=dy)
        if dh is not None:
            ins["dh_final"] = dh
        names = ("dx", "ddt", "dA", "dB", "dC", "dD")
        want = dict(zip(names, ref.ssm_scan_ref_grads(x, dt, A, Bc, Cc, D, dy,
                                                      dh)))
        outs = {nm: (tuple(t.shape), torch.float32) for nm, t in zip(
            names, (x, x, A, Bc, Cc, D))}
        scratch = {"scratch": build_scratch("ssm_scan_bwd", B, S, di, n)}

        def args(P):
            return (P["x"], P["dt"], P["A"], P["Bc"], P["Cc"], P["D"],
                    P["states"], P["dy"], P.get("dh_final", 0), P["dx"],
                    P["ddt"], P["dA"], P["dB"], P["dC"], P["dD"],
                    P["scratch"], scratch["scratch"], B, S, di, n)
        return ins, want, outs, scratch, args
    B, H, K, S, Sk, D, Dv = (s[k] for k in ("B", "H", "K", "S", "Sk", "D",
                                            "Dv"))
    dtype = torch.bfloat16 if s["bf16"] else torch.float32
    q, k, v = randn(B, H, S, D, dtype=dtype), randn(B, K, Sk, D, dtype=dtype), \
        randn(B, K, Sk, Dv, dtype=dtype)
    window = s["window"] or None
    scale = 1.0 / math.sqrt(D)
    mask = dict(causal=bool(s["causal"]), window=window, sink=s["sink"])
    if p.lib == "flash_attention":
        ins = {"q": q, "k": k, "v": v}
        want = {"o": ref.attention_ref(q, k, v, round_p=bool(s["round_p"]),
                                       **mask)}
        outs = {"o": ((B, H, S, Dv), dtype)}
        if s["lse"]:
            outs["lse"] = ((B, H, S), torch.float32)

        def args(P):
            return (P["q"], P["k"], P["v"], P["o"], P.get("lse", 0), B, H, K,
                    S, Sk, D, Dv, scale, s["bf16"], s["causal"], s["window"],
                    s["sink"], s["round_p"])
        return ins, want, outs, {}, args
    o, lse = kflash._forward(q, k, v, mask["causal"], window, s["sink"], False,
                             with_lse=True)
    do = randn(B, H, S, Dv, dtype=dtype)
    ins = {"q": q, "k": k, "v": v, "o": o, "do": do, "lse": lse}
    want = dict(zip(("dq", "dk", "dv"),
                    ref.attention_ref_grads(q, k, v, do, **mask)))
    outs = {"dq": (tuple(q.shape), dtype), "dk": (tuple(k.shape), dtype),
            "dv": (tuple(v.shape), dtype)}
    scratch = {"scratch": build_scratch("flash_attention_bwd", B, H, K, S, Sk,
                                        D, Dv, s["bf16"])}

    def args(P):
        return (P["q"], P["k"], P["v"], P["o"], P["do"], P["lse"],
                P["scratch"], scratch["scratch"], P["dq"], P["dk"], P["dv"],
                B, H, K, S, Sk, D, Dv, scale, s["bf16"], s["causal"],
                s["window"], s["sink"])
    return ins, want, outs, scratch, args


def build_scratch(name: str, *shape) -> int:
    from repro_torch.kernels import build
    return build.scratch_floats(name, *shape)


def run_card_profile(p: CardProfile, device, seed: int = 0) -> List[dict]:
    """One profile's guarded launches: two, each on buffers reset to the
    sentinel; returns the issues ({rule, message}) found."""
    import torch
    from repro_torch.kernels import build
    ins, want, outs, scratch, args = _inputs(p, device, seed)
    torch.cuda.synchronize(device)
    guarded = {nm: Guarded(t.numel(), t.dtype, device, "nan", t)
               for nm, t in ins.items()}
    for nm, (shape, dtype) in outs.items():
        guarded[nm] = Guarded(math.prod(shape), dtype, device, "sentinel")
    for nm, floats in scratch.items():
        guarded[nm] = Guarded(floats, torch.float32, device, "sentinel")
    issues: List[dict] = []
    results = []
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(2):
        for nm in list(outs) + list(scratch):
            guarded[nm].reset()
        ptrs = {nm: gb.ptr() for nm, gb in guarded.items()}
        build.launch(p.lib, *args(ptrs), stream)
        torch.cuda.synchronize(device)
        results.append({nm: guarded[nm].bits()[
            guarded[nm].guard:guarded[nm].guard + guarded[nm].numel].clone()
            for nm in outs})
        for nm, gb in guarded.items():
            if gb.guards_changed():
                issues.append({"rule": "LG03", "message":
                               f"a guard band of {nm} changed"})
            if nm in ins and gb.interior_changed():
                issues.append({"rule": "LG03", "message":
                               f"input {nm} was written"})
        for nm in outs:
            left = guarded[nm].unwritten()
            if left:
                issues.append({"rule": "LG02", "message":
                               f"{left} of {guarded[nm].numel} elements of "
                               f"{nm} never written"})
            if nm in want:
                got = guarded[nm].interior.reshape(want[nm].shape)
                bad = int((torch.isnan(got.float())
                           & torch.isfinite(want[nm].float())).sum())
                if bad:
                    issues.append({"rule": "LG03", "message":
                                   f"{bad} elements of {nm} NaN where the "
                                   f"plain version's are finite"})
    if p.lib in DETERMINISTIC:
        for nm in outs:
            if not torch.equal(results[0][nm], results[1][nm]):
                issues.append({"rule": "LG04", "message":
                               f"{nm} differs between two launches"})
    return list({(i["rule"], i["message"]): i for i in issues}.values())


def check_card(project, device=None, seed: int = 0
               ) -> Tuple[List[Finding], dict]:
    """LG02-LG04 over every card profile; returns the findings and counts
    (profiles, guarded launches, routes)."""
    import torch
    device = torch.device(device or "cuda")
    findings: List[Finding] = []
    routes = set()
    n = 0
    for i, p in enumerate(card_profiles()):
        for issue in run_card_profile(p, device, seed + i):
            findings.append(Finding(
                issue["rule"], WRAPPERS[p.lib], 0,
                f"{p.lib} {p.route} at {p.label}: {issue['message']}",
                snippet=f"{p.lib}:{p.route}@{p.label}"))
        routes.add((p.lib, p.route))
        n += 2
    return findings, {"profiles": len(card_profiles()), "launches": n,
                      "routes": len(routes)}


def check(project) -> List[Finding]:
    """LG01 and LG05's static half everywhere; on a card also LG02-LG04."""
    import torch
    findings, _ = check_static(project)
    if torch.cuda.is_available():
        findings += check_card(project)[0]
    return findings
