"""Rule registry of the port's static analyzer.

Pure data, stdlib-only, no intra-package imports: the catalog is the audit
surface, and ``docs/ANALYSIS_TORCH.md`` documents every ID below (DC03).

Rule IDs group into families by two-letter prefix; the family prefix is also
the unit of the CLI exit-code bitmask (see ``EXIT_BITS``). Each family keeps
the bit of its counterpart in the JAX package's analyzer:

  CK  cache-key completeness    (policy fields / ingredients -> cache keys)
  HS  host sync                 (functions reachable from the hot entry
                                 points; JP's counterpart)
  US  unit-suffix convention    (physics-layer naming + unit algebra)
  KC  kernel coverage           (every CUDA library: wrapper, plain
                                 version, CPU test, card test, smoke phase;
                                 BK's counterpart)
  DC  docs                      (links, anchors, rule catalog, obs catalog)

Semantic tier (``--semantic``, imports torch):

  LG  launch verifier           (static launch geometry, and on the card
                                 every kernel's writes in guarded buffers;
                                 PB's counterpart)
  DT  dtype audit               (aten ops of the entry points vs policy)
  RC  recompile / rebuild budget (kernel builds a drive makes; compile
                                 sites)
"""
from __future__ import annotations

# id -> (title, one-line description)
RULES = {
    "CK01": ("policy-field-not-keyed",
             "a field of a policy dataclass does not flow into the cache-key "
             "construction that fingerprints it"),
    "CK02": ("key-param-unused",
             "a parameter of a cache-key function is never read in its body "
             "(an input that cannot affect the key)"),
    "CK03": ("key-ingredient-missing",
             "a cache-key function no longer references a required "
             "ingredient (e.g. grid_hash without corners_fingerprint)"),
    "CK04": ("physics-fingerprint-drift",
             "a module or CUDA source in the import closure of the "
             "characterization pipeline is neither hashed by "
             "_physics_fingerprint nor exempted with a reason"),
    "CK05": ("key-spec-target-missing",
             "a file/function/class named by the cache-key checker spec "
             "does not exist, or an exemption names a module outside the "
             "closure (the analyzer spec rotted)"),
    "HS01": ("host-sync",
             ".item()/.tolist()/.cpu()/.numpy(), torch.cuda.synchronize(), "
             "or a blocking host-to-device copy in a function reachable "
             "from a hot entry point"),
    "HS02": ("host-sync-cast-or-branch",
             "float()/int()/bool() of a tensor expression, or a Python "
             "if/while/ternary on one, in a hot-reachable function (the "
             "host waits for the device)"),
    "HS03": ("data-dependent-shape",
             "nonzero/masked_select/unique, a boolean-mask index, or "
             "repeat_interleave without output_size in a hot-reachable "
             "function (the output's size needs a host sync)"),
    "US01": ("unit-suffix-missing",
             "a physics binding (t_/e_/p_/f_/i_/l_/c_/r_/v_ prefix, or a "
             "quantity with an inferable unit) lacks a unit suffix"),
    "US02": ("unit-mix",
             "arithmetic (+/-, comparison, min/max) mixes incompatible unit "
             "suffixes, e.g. adding _w to _j"),
    "US03": ("unit-suffix-conflict",
             "a binding's unit suffix conflicts with the unit inferred from "
             "its right-hand side (or with its prefix convention)"),
    "KC01": ("library-without-wrapper",
             "a CUDA library of kernels/build.py's LAUNCH_ARGTYPES is "
             "launched by no wrapper (no build.launch call names it)"),
    "KC02": ("library-without-plain-version",
             "a library's wrapper has no plain version in kernels/ref.py, "
             "or no CPU test references that plain version"),
    "KC03": ("library-untested-on-card",
             "a library is launched by no cuda-marked test or by no "
             "chip_smoke.py phase"),
    "DC01": ("doc-broken-link",
             "a markdown link of the port's docs targets a file that does "
             "not exist"),
    "DC02": ("doc-broken-anchor",
             "a markdown link of the port's docs targets a #anchor with no "
             "matching heading"),
    "DC03": ("rule-undocumented",
             "a rule ID of the port's analyzer is not documented in "
             "docs/ANALYSIS_TORCH.md"),
    "DC04": ("obs-name-undocumented",
             "a repro_torch.obs catalog entry (span/metric name) is not "
             "documented in docs/OBSERVABILITY_TORCH.md"),
    "LG01": ("launch-geometry-limit",
             "at a shape profile the wrapper accepts, a launch exceeds a "
             "Hopper limit: grid y/z > 65,535, grid x > 2^31 - 1, threads > "
             "1,024, dynamic shared memory > 227 KB, or a size the .cu "
             "holds in a 32-bit int or a packed field"),
    "LG02": ("launch-output-gap",
             "on the card, an output element still holds the sentinel NaN "
             "after the launch (never written)"),
    "LG03": ("launch-out-of-bounds",
             "on the card, a guard band or an input changed, or an output "
             "is NaN where the plain version's is finite (a read past an "
             "operand reached its NaN guard band)"),
    "LG04": ("launch-nondeterministic",
             "on the card, two launches of a kernel declared deterministic "
             "on the same inputs are not bit-equal (a race)"),
    "LG05": ("launch-unprofiled",
             "a library, a (D, Dv) pair, an instantiation in csrc/*.cu or a "
             "route seen launched has no LG profile (the spec rotted)"),
    "DT01": ("dtype-policy-violation",
             "an entry point's device computation makes a float64, float16 "
             "or complex tensor (float64 belongs to host numpy)"),
    "DT02": ("output-not-declared-tensor",
             "an entry point returns a top-level output that is not a "
             "tensor of its declared dtype (a Python or numpy scalar leaked "
             "through)"),
    "DT03": ("int-accumulation-overflow",
             "a sum, cumsum or matmul accumulates in a sub-32-bit integer "
             "dtype"),
    "DT04": ("dt-spec-rot",
             "a DT entry-point spec no longer resolves (module/attr gone or "
             "its drive failed)"),
    "RC01": ("build-budget-exceeded",
             "a first drive of the entry points built a kernel library more "
             "than once, or one outside the five"),
    "RC02": ("rebuild-on-repeat",
             "a repeat drive of the same entry points built a library again "
             "(the build key is unstable)"),
    "RC03": ("compile-site-unbudgeted",
             "a torch.compile / torch.jit site in the port has no budget "
             "entry"),
    "RC04": ("rc-spec-rot",
             "an RC driver failed on the first or the repeat drive, or a "
             "budget entry no longer resolves"),
}

FAMILIES = ("CK", "HS", "US", "KC", "DC", "LG", "DT", "RC")

# exit-code bitmask per family: the CLI exits with the OR of the bits of
# every family that produced at least one active (unsuppressed, unbaselined)
# finding. 0 = clean.
EXIT_BITS = {"CK": 1, "HS": 2, "US": 4, "KC": 8, "DC": 16,
             "LG": 32, "DT": 64, "RC": 128}


def family_of(rule_id: str) -> str:
    return rule_id[:2]


def is_known(rule_id: str) -> bool:
    return rule_id in RULES
