"""The port's analyzer (``repro_torch.analysis``) on the CPU: per rule a
fixture that fires it and one that stays clean (source overlays on the real
tree for CK, ``tmp_path`` trees for HS/US/KC/DC), the live port clean
against ``analysis_baseline_torch.json``, the CLI, the AST tier's imports,
LG01 / LG05 over every profile, the guarded buffers of LG02-LG04, DT over
the CPU entries, RC, and the pieces shared with the JAX package's analyzer
held equal to it on the same inputs (``repro.analysis``, the reference).

The card half (LG02-LG04 launches, the host-sync witness) is in
``tests/test_torch_cuda.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import docs as jax_docs
from repro.analysis import findings as jax_findings
from repro.analysis import units as jax_units
from repro.analysis import cache_keys as jax_cache_keys
from repro.analysis.astutil import Project as JaxProject
from repro_torch.analysis import cache_keys, host_sync, kernel_cov, units
from repro_torch.analysis import docs as docs_mod
from repro_torch.analysis import findings as findings_mod
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.astutil import Project
from repro_torch.analysis.findings import (Baseline, Finding, is_suppressed,
                                           noqa_rules)
from repro_torch.analysis.rules import EXIT_BITS, FAMILIES, RULES, family_of
from repro_torch.analysis.runner import (SEMANTIC_FAMILIES, report_of,
                                         run_analysis)
from repro_torch.analysis.semantic import capture, dt, lg, rc, witness

ROOT = Path(__file__).resolve().parents[1]


def _read(rel):
    return (ROOT / rel).read_text(encoding="utf-8")


def _overlay(rel, old, new, project_cls=Project):
    """Project over the real repo with one source mutation injected."""
    src = _read(rel)
    assert old in src, f"anchor drifted in {rel}: {old!r}"
    return project_cls(ROOT, overlay={rel: src.replace(old, new)})


def _write_tree(root, files):
    for rel, body in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body), encoding="utf-8")
    return root


# ------------------------------------------------------------------ rules
def test_rule_catalog_shape():
    assert set(EXIT_BITS) == set(FAMILIES)
    assert sorted(EXIT_BITS.values()) == [1 << i for i in range(8)]
    for rid, (title, summary) in RULES.items():
        assert family_of(rid) in FAMILIES, rid
        assert title and summary


def test_exit_bits_keep_the_jax_counterparts():
    from repro.analysis.rules import EXIT_BITS as JAX_BITS
    counterpart = {"CK": "CK", "HS": "JP", "US": "US", "KC": "BK",
                   "DC": "DC", "LG": "PB", "DT": "DT", "RC": "RC"}
    assert {f: JAX_BITS[j] for f, j in counterpart.items()} == EXIT_BITS


# ------------------------------------------------- CK: cache-key coverage
def test_ck_live_port_clean():
    assert cache_keys.check(Project(ROOT)) == []


_OP_FIELD = ('    corner: str = "nominal"',
             '    corner: str = "nominal"\n    body_bias_v: float = 0.0')


def test_ck01_new_operating_point_field_caught():
    project = _overlay("src/repro_torch/core/corners.py", *_OP_FIELD)
    found = [f for f in cache_keys.check(project) if f.rule == "CK01"]
    assert any("body_bias_v" in f.message for f in found)


def test_ck01_same_injected_field_as_the_jax_analyzer():
    """The same OperatingPoint field, injected through each analyzer's
    overlay on its own tree, gives the same CK01 finding."""
    mine = cache_keys.check(
        _overlay("src/repro_torch/core/corners.py", *_OP_FIELD))
    theirs = jax_cache_keys.check(
        _overlay("src/repro/core/corners.py", *_OP_FIELD,
                 project_cls=JaxProject))
    key = lambda fs: sorted((f.rule, f.snippet) for f in fs)   # noqa: E731
    assert key(mine) == key(theirs) != []


def test_ck_asdict_keyed_policy_field_is_covered():
    """report_key hashes dataclasses.asdict(policy): a new SelectionPolicy
    field must not flag."""
    project = _overlay(
        "src/repro_torch/core/select.py",
        "    refresh_power_frac: float = 0.1\n",
        "    refresh_power_frac: float = 0.1\n    synthetic_knob: float = 1.0\n")
    assert cache_keys.check(project) == []


def test_ck_grid_hash_corners_removal_caught():
    project = _overlay(
        "src/repro_torch/api.py",
        "    h.update(corners_mod.corners_fingerprint(\n"
        "        corners_mod.as_corners(corners)).encode())\n", "")
    found = cache_keys.check(project)
    assert {"CK02", "CK03"} <= {f.rule for f in found}
    assert any("corners_fingerprint" in f.message for f in found)


def test_ck01_macro_config_field_missing_from_vec_fields():
    project = _overlay("src/repro_torch/core/macro.py",
                       "    word_size: int = 32 ",
                       "    ports: int = 1\n    word_size: int = 32 ")
    found = cache_keys.check(project)
    assert [f.rule for f in found] == ["CK01"]
    assert "MacroConfig.ports" in found[0].message


@pytest.mark.parametrize("old,new,missing", [
    ('"core/tech.py",\n', "\n", "core/tech.py"),
    ('    h.update(" ".join(kbuild.NVCC_FLAGS).encode())\n', "",
     "kernels/build.py"),
], ids=["source-dropped", "nvcc-flags-dropped"])
def test_ck04_closure_file_not_hashed_caught(old, new, missing):
    project = _overlay("src/repro_torch/api.py", old, new)
    found = cache_keys.check(project)
    assert [f.snippet for f in found] == [f"_physics_fingerprint<-{missing}"]
    assert found[0].rule == "CK04"


def test_ck04_new_import_in_the_closure_caught():
    project = _overlay("src/repro_torch/core/characterize.py",
                       "from __future__ import annotations\n",
                       "from __future__ import annotations\n"
                       "from repro_torch.hetero import cache\n")
    found = {f.snippet for f in cache_keys.check(project)}
    assert "_physics_fingerprint<-hetero/cache.py" in found


def test_ck04_closure_includes_the_kernel_source():
    closure = cache_keys.import_closure(Project(ROOT),
                                        "core/characterize.py")
    assert {"kernels/csrc/retention.cu", "kernels/build.py",
            "kernels/retention.py", "core/tech.py"} <= closure
    assert not any(rel.startswith(("models/", "hetero/"))
                   for rel in closure)


def test_ck05_spec_rot_caught(monkeypatch):
    project = _overlay("src/repro_torch/hetero/cache.py",
                       "def sim_report_key(", "def sim_report_key_v2(")
    rot = [f for f in cache_keys.check(project) if f.rule == "CK05"]
    assert rot and all("sim_report_key" in f.message for f in rot)
    monkeypatch.setitem(cache_keys.CLOSURE_EXEMPT, "sim/engine.py", "x")
    rot = [f for f in cache_keys.check(Project(ROOT)) if f.rule == "CK05"]
    assert [f.snippet for f in rot] == [
        "exemption sim/engine.py outside the closure of "
        "core/characterize.py"]


def test_ck_exit_bit_through_runner():
    project = _overlay("src/repro_torch/core/corners.py", *_OP_FIELD)
    report = run_analysis(ROOT, checks=("CK",), project=project)
    assert report.exit_code == EXIT_BITS["CK"]


def test_nvcc_flags_change_the_grid_hash(monkeypatch):
    """The repaired key: the retention kernel's compiler flags decide its
    values, so a changed flag must miss every cached table."""
    from repro_torch import api
    from repro_torch.kernels import build
    configs = api.design_space(mem_types=("gc_sisi",), word_sizes=(32,),
                               num_words=(64,))
    api._physics_fingerprint.cache_clear()
    before = api.grid_hash(configs)
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ("--use_fast_math",))
    api._physics_fingerprint.cache_clear()
    try:
        assert api.grid_hash(configs) != before
    finally:
        monkeypatch.undo()
        api._physics_fingerprint.cache_clear()
    assert api.grid_hash(configs) == before


# --------------------------------------------------- HS: host syncs
_HS_REL = "src/repro_torch/core/toy.py"


def _hs_root(tmp_path, monkeypatch, body, extra=None):
    monkeypatch.setattr(host_sync, "HOT_ENTRIES", ((_HS_REL, "entry"),))
    files = {_HS_REL: "import numpy as np\nimport torch\n"
             "import torch.nn.functional as F\n" + textwrap.dedent(body)}
    files.update(extra or {})
    return _write_tree(tmp_path, files)


def test_hs_clean_fixture(tmp_path, monkeypatch):
    root = _hs_root(tmp_path, monkeypatch, """
        def entry(x, n: int):
            y = torch.exp(x) * 2.0
            if x.shape[0] > n and x.dtype == torch.float32:
                y = y + 1.0
            k = int(x.shape[1]) + len(x)
            a = np.arange(4).tolist()
            return torch.where(y > 0, y, 0.0), k, a
        """)
    assert host_sync.check(Project(root)) == []


def test_hs_bad_fixture_all_rules(tmp_path, monkeypatch):
    root = _hs_root(tmp_path, monkeypatch, """
        def entry(x, dev, pos: int):
            y = torch.exp(x)
            v = y.sum().item()                       # HS01
            h = y.cpu()                              # HS01
            c = torch.tensor([1.0], device=dev)      # HS01
            y[0] = pos                               # HS01
            f = float(y.max())                       # HS02
            if y.mean() > 0:                         # HS02
                v += 1
            idx = torch.nonzero(y)                   # HS03
            m = y > 0
            sel = y[m]                               # HS03
            r = y.repeat_interleave(y.long())        # HS03
            return v, h, c, f, idx, sel, r
        """)
    found = host_sync.check(Project(root))
    rules = sorted(f.rule for f in found)
    assert rules == ["HS01"] * 4 + ["HS02"] * 2 + ["HS03"] * 3, rules


def test_hs_unreachable_function_not_linted(tmp_path, monkeypatch):
    root = _hs_root(tmp_path, monkeypatch, """
        def entry(x):
            return torch.exp(x)

        def cold(x):
            return torch.exp(x).item()
        """)
    assert host_sync.check(Project(root)) == []


def test_hs_type_guards_and_cpu_branches_skipped(tmp_path, monkeypatch):
    """isinstance / is-None tests do not flag; a branch only a CPU tensor
    takes makes no sync and is not linted."""
    root = _hs_root(tmp_path, monkeypatch, """
        def entry(x, tp=None):
            if tp is None or isinstance(x, list):
                tp = 1.0
            if x.device.type == "cpu":
                return torch.exp(x).item()
            return torch.exp(x) * tp
        """)
    assert host_sync.check(Project(root)) == []


def test_hs_reachability_through_call_edges(tmp_path, monkeypatch):
    """Helpers in other modules, self. methods and methods of an untyped
    receiver are reached."""
    root = _hs_root(tmp_path, monkeypatch, """
        from repro_torch.core import helper

        class Box:
            def run(self, x):
                return self.read(x)

            def read(self, x):
                return torch.exp(x).item()

        def entry(x, box):
            helper.pull(x)
            box.lift(x)
            return Box().run(x)
        """, extra={"src/repro_torch/core/helper.py": """
        import torch

        class Table:
            def lift(self, x):
                return x.to("cuda")

        def pull(x):
            return torch.exp(x).cpu()
        """})
    found = host_sync.check(Project(root))
    assert sorted((Path(f.path).name, f.rule) for f in found) == [
        ("helper.py", "HS01"), ("helper.py", "HS01"), ("toy.py", "HS01")]
    assert any("'read'" in f.message for f in found)


def test_hs_noqa_suppression_via_runner(tmp_path, monkeypatch):
    root = _hs_root(tmp_path, monkeypatch, """
        def entry(x):
            return torch.exp(x).cpu()  # noqa: HS01 (the result to the host)
        """)
    report = run_analysis(root, checks=("HS",))
    assert report.findings == [] and report.exit_code == 0
    assert [f.rule for f in report.suppressed] == ["HS01"]


def test_hs_gone_entry_point_reported(tmp_path, monkeypatch):
    root = _hs_root(tmp_path, monkeypatch, "def other(x):\n    return x\n")
    found = host_sync.check(Project(root))
    assert [f.rule for f in found] == ["HS01"]
    assert "no longer resolves" in found[0].message


def test_hs_live_port_syncs_each_carry_a_reason():
    """Every hot-path sync of the port is marked with its rule and a
    reason, and the entry points all resolve."""
    project = Project(ROOT)
    found = host_sync.check(project)
    assert found and all(f.line for f in found)
    for f in found:
        line = project.module(f.path).line(f.line)
        rules = noqa_rules(line)
        assert rules and f.rule in rules, f.format()
        assert line.rstrip().endswith(")"), f"no reason: {f.format()}"
    assert len(host_sync.reachable(project)) > 200


def test_witness_unflagged_uses_the_statement_span():
    project = Project(ROOT)
    lm = "src/repro_torch/models/lm.py"
    noqa_line = next(i for i, ln in enumerate(_read(lm).splitlines(), 1)
                     if "noqa: HS01 (the position" in ln)
    sites = [(lm, noqa_line), (lm, 1), witness.OUTSIDE, witness.OUTSIDE]
    assert witness.unflagged(project, sites) == [witness.OUTSIDE, (lm, 1)]


# ------------------------------------------------------ US: unit suffixes
def _us_root(tmp_path, body, pkg="repro_torch"):
    return _write_tree(tmp_path, {f"src/{pkg}/core/periphery.py":
                                  textwrap.dedent(body)})


_US_BAD = """
    def stage(width_um, t_step_s, c_load_f, v_swing_v):
        area = width_um * width_um       # US01: word prefix, no suffix
        t_bad_hz = t_step_s              # US03: suffix vs prefix/RHS
        mix_s = width_um + t_step_s      # US02: um + s
        charge = c_load_f * v_swing_v    # US01: inferable unit
        lim_w = torch.clamp_min(mix_s, 1e-9)
        return area, t_bad_hz, mix_s, charge, lim_w
    """


def test_us_clean_fixture(tmp_path):
    root = _us_root(tmp_path, """
        C_GATE_PER_UM = 1e-15

        def stage(width_um, c_load_f, r_drv_ohm):
            area_um2 = width_um * width_um
            t_rc_s = r_drv_ohm * torch.clamp_min(c_load_f, 1e-18)
            f_max_hz = 1.0 / t_rc_s
            return area_um2, t_rc_s, f_max_hz
        """)
    assert units.check(Project(root)) == []


def test_us_bad_fixture_all_rules(tmp_path):
    found = units.check(Project(_us_root(tmp_path, _US_BAD)))
    assert {"US01", "US02", "US03"} <= {f.rule for f in found}
    assert any(f.rule == "US01" and "charge" in f.snippet for f in found)
    # torch.clamp_min passes the unit through: _s assigned to _w
    assert any(f.rule == "US03" and "lim_w" in f.snippet for f in found)


def test_us_findings_equal_the_jax_analyzer_on_one_source(tmp_path):
    """One fixture source planted in each package's tree: the same
    findings (the torch spellings aside, the algebra is one)."""
    src = _US_BAD.replace("torch.clamp_min", "jnp.maximum")
    mine = units.check(Project(_us_root(tmp_path / "a", src)))
    theirs = jax_units.check(JaxProject(_us_root(tmp_path / "b", src,
                                                 "repro")))
    key = lambda fs: [(f.rule, f.line, f.snippet) for f in fs]  # noqa: E731
    assert key(mine) == key(theirs) and mine


def test_unit_algebra_equals_the_jax_analyzer():
    names = ["t_ret_s", "e_read_j", "area", "area_um2", "v_a", "bw_bits_s",
             "top_k", "C_GATE", "_private_w", "leak", "l_sa", "i_x_a", "w",
             "freq_hz", "p_leak_w", "r_ohm", "c_sn_f", "k_k", "x_bits"]
    for n in names:
        assert units.suffix_dim(n) == jax_units.suffix_dim(n), n
        assert units.prefix_dim(n) == jax_units.prefix_dim(n), n
    dims = list(units.SUFFIX_DIMS.values()) + [units.WILDCARD, None,
                                               units.DIMLESS]
    for a in dims:
        for b in dims:
            for op in ("add", "mul", "div"):
                assert units._combine(a, b, op) == \
                    jax_units._combine(a, b, op), (a, b, op)


def test_us_noqa_suppression_via_runner(tmp_path):
    root = _us_root(tmp_path, """
        def stage(width_um):
            area = width_um * width_um  # noqa: US01
            return area
        """)
    report = run_analysis(root, checks=("US",))
    assert report.findings == []
    assert [f.rule for f in report.suppressed] == ["US01"]


def test_us_live_targets_clean():
    assert units.check(Project(ROOT)) == []


# ------------------------------------------------ KC: kernel coverage
def _kc_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_cov, "PLAIN_VERSIONS",
                        {"full": "full_ref", "uncarded": "uncarded_ref"})
    return _write_tree(tmp_path, {
        "src/repro_torch/kernels/build.py": """
            LAUNCH_ARGTYPES = {"full": [], "naked": [], "uncarded": []}
            """,
        "src/repro_torch/kernels/full.py": """
            from repro_torch.kernels import build

            def _go(x):
                build.launch("full", x)

            def full_op(x):
                return _go(x)

            def uncarded_op(x):
                build.launch("uncarded", x)
            """,
        "src/repro_torch/kernels/ref.py": """
            def full_ref(x):
                return x

            def uncarded_ref(x):
                return x
            """,
        "tests/test_torch_full.py": """
            def test_plain():
                assert full_ref and uncarded_ref
            """,
        "tests/test_torch_cuda.py": """
            import pytest

            @pytest.mark.cuda
            def test_card():
                full_op(1)
            """,
        "chip_smoke.py": "full_op(1)\nuncarded_op(1)\n",
    })


def test_kc_rules_fire_per_missing_path(tmp_path, monkeypatch):
    found = kernel_cov.check(Project(_kc_tree(tmp_path, monkeypatch)))
    got = sorted((f.rule, f.snippet.rsplit("<-", 1)[1]) for f in found)
    assert got == [("KC01", "naked"), ("KC02", "naked"),
                   ("KC03", "uncarded")]


def test_kc_live_port_clean():
    assert kernel_cov.check(Project(ROOT)) == []
    libs, _ = kernel_cov.libraries(Project(ROOT))
    assert sorted(libs) == sorted(kernel_cov.PLAIN_VERSIONS)


# ------------------------------------------------------------ DC: docs
def test_dc_broken_link_and_anchor(tmp_path):
    _write_tree(tmp_path, {
        "docs/GOOD_TORCH.md": """
            # Title

            ## Real Section

            [ok](GOOD_TORCH.md#real-section) [also ok](BAD_TORCH.md)
            """,
        "docs/BAD_TORCH.md": """
            [gone](NOPE.md) and [bad anchor](GOOD_TORCH.md#no-such-section)
            """,
        "docs/OTHER.md": "[not the port's](NOPE.md)\n",
    })
    found = docs_mod.check_links(tmp_path)
    assert sorted(d["rule"] for d in found) == ["DC01", "DC02"]
    assert all(d["path"] == "docs/BAD_TORCH.md" for d in found)


def test_dc_reads_only_the_readme_port_section(tmp_path):
    _write_tree(tmp_path, {"README.md": """
        # Repo

        [not the port's](GONE.md)

        ## PyTorch/CUDA port (`repro_torch`)

        [broken](ALSO_GONE.md)

        ## Later

        [not the port's either](GONE_TOO.md)
        """})
    found = docs_mod.check_links(tmp_path)
    assert [d["snippet"] for d in found] == ["ALSO_GONE.md"]


def test_dc_rule_catalog_must_document_every_rule(tmp_path):
    _write_tree(tmp_path, {"docs/ANALYSIS_TORCH.md": "only CK01\n"})
    found = docs_mod.check_rule_docs(tmp_path, ["CK01", "HS01"])
    assert [d["rule"] for d in found] == ["DC03"]
    assert "HS01" in found[0]["message"]


def test_dc04_obs_catalog_must_be_documented(tmp_path):
    _write_tree(tmp_path, {
        "src/repro_torch/obs/catalog.py":
            'SPANS = {"a.b": ()}\nMETRICS = {"c.d": ()}\n',
        "docs/OBSERVABILITY_TORCH.md": "`a.b` only\n"})
    found = docs_mod.check_obs_docs(tmp_path)
    assert [(d["rule"], d["snippet"]) for d in found] == [("DC04", "c.d")]


def test_dc_live_docs_clean():
    report = run_analysis(ROOT, checks=(), with_docs=True)
    assert report.findings == [], report.format_text()


def test_dc_port_docs_link_only_the_readme_and_docs(tmp_path):
    """The port's docs stay clean in a checkout that holds the README and
    docs/ and none of the project's records (ROADMAP.md, PERF.md,
    CHANGES.md): chip_smoke.py's phase 42 runs DC wherever it is checked
    out."""
    (tmp_path / "README.md").write_text(
        (ROOT / "README.md").read_text(encoding="utf-8"), encoding="utf-8")
    (tmp_path / "docs").mkdir()
    for doc in (ROOT / "docs").glob("*.md"):
        (tmp_path / "docs" / doc.name).write_text(
            doc.read_text(encoding="utf-8"), encoding="utf-8")
    assert docs_mod.check_links(tmp_path) == []


def test_slugs_and_anchors_equal_the_jax_analyzer():
    headings = ["## The `repro_torch` port", "Rule catalog", "LG — launch "
                "verifier (exit bit 32, semantic tier)", "a_b [c](d.md) *e*",
                "Tests (tier-1)"]
    for h in headings:
        assert docs_mod.slugify(h) == jax_docs.slugify(h), h
    for md in sorted((ROOT / "docs").glob("*.md")):
        assert docs_mod.anchors_of(md) == jax_docs.anchors_of(md), md


# ------------------------------------------- baseline + noqa mechanics
_NOQA_LINES = ["x = 1", "x = 1  # noqa", "x = 1  # noqa: US01",
               "x = 1  # NOQA: us01, hs02", "x  # noqa: F401  (re-export)",
               "y = f(x)  # noqa: HS01 (to the host)", "# noqa:HS03,CK01"]


def test_noqa_parsing():
    assert noqa_rules("x = 1") is None
    assert noqa_rules("x = 1  # noqa") == frozenset()
    assert noqa_rules("x = 1  # NOQA: us01, hs02") == {"US01", "HS02"}
    f = Finding("US01", "a.py", 1, "m")
    assert is_suppressed(f, "x  # noqa: US01,CK02")
    assert not is_suppressed(f, "x  # noqa: CK02")
    assert not is_suppressed(f, "x")


def test_noqa_and_baseline_equal_the_jax_analyzer(tmp_path):
    for line in _NOQA_LINES:
        assert noqa_rules(line) == jax_findings.noqa_rules(line), line
    rows = [("US01", "src/a.py", 10, "area = w * w"),
            ("HS01", "src/b.py", 3, "v = y.item()"),
            ("CK04", "src/c.py", 0, "fp<-x")]
    mine = [Finding(*r[:3], "m", snippet=r[3]) for r in rows]
    theirs = [jax_findings.Finding(*r[:3], "m", snippet=r[3]) for r in rows]
    Baseline.write(tmp_path / "a.json", mine[:2], {mine[0].key(): "why"})
    jax_findings.Baseline.write(tmp_path / "b.json", theirs[:2],
                                {theirs[0].key(): "why"})
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    b, jb = Baseline.load(tmp_path / "a.json"), \
        jax_findings.Baseline.load(tmp_path / "b.json")
    split = [[f.key() for f in part] for part in b.split(mine)]
    jsplit = [[f.key() for f in part] for part in jb.split(theirs)]
    assert split == jsplit
    assert b.stale_entries(mine[1:]) == jb.stale_entries(theirs[1:])


def test_baseline_roundtrip_and_snippet_matching(tmp_path):
    f1 = Finding("US01", "src/a.py", 10, "msg", snippet="area = w * w")
    f2 = Finding("HS02", "src/b.py", 3, "msg", snippet="v = float(y)")
    path = tmp_path / "baseline.json"
    Baseline.write(path, [f1], {f1.key(): "deliberate: legacy name"})
    b = Baseline.load(path)
    assert b.entries[0]["justification"] == "deliberate: legacy name"
    shifted = Finding("US01", "src/a.py", 99, "msg", snippet="area = w * w")
    assert b.split([shifted, f2]) == ([f2], [shifted])
    edited = Finding("US01", "src/a.py", 10, "msg", snippet="area = w * h")
    assert b.split([edited])[0] == [edited]
    assert b.stale_entries([f2]) == b.entries


def test_baseline_missing_file_is_empty(tmp_path):
    b = Baseline.load(tmp_path / "nope.json")
    f = Finding("US01", "a.py", 1, "m")
    assert b.split([f]) == ([f], []) and b.stale_entries([]) == []


def test_exit_code_bitmask_composes(tmp_path, monkeypatch):
    root = _hs_root(tmp_path, monkeypatch, """
        def entry(x):
            return torch.exp(x).item()
        """, extra={"src/repro_torch/core/periphery.py": """
        def stage(width_um):
            area = width_um * width_um
            return area
        """})
    report = run_analysis(root, checks=("HS", "US"))
    assert report.exit_code == EXIT_BITS["HS"] | EXIT_BITS["US"]


def test_report_of_applies_noqa_and_baseline(tmp_path):
    """The card's phase gathers semantic findings itself; report_of applies
    the same suppression layers."""
    _write_tree(tmp_path, {"src/repro_torch/x.py": "a = 1  # noqa: LG01\n"})
    (tmp_path / "analysis_baseline_torch.json").write_text(json.dumps(
        {"entries": [{"rule": "DT01", "path": "p", "snippet": "s",
                      "justification": "why"}]}))
    raw = [Finding("LG01", "src/repro_torch/x.py", 1, "m"),
           Finding("DT01", "p", 0, "m", snippet="s"),
           Finding("RC02", "p", 0, "m", snippet="t")]
    report = report_of(Project(tmp_path), raw, ("LG", "DT", "RC"))
    assert [f.rule for f in report.findings] == ["RC02"]
    assert [f.rule for f in report.suppressed] == ["LG01"]
    assert [f.rule for f in report.baselined] == ["DT01"]
    assert report.exit_code == EXIT_BITS["RC"]


# ------------------------------------------------------------------- CLI
def test_cli_json_live_port_clean(tmp_path, capsys):
    out = tmp_path / "report.json"
    code = main(["--root", str(ROOT), "--docs", "--format=json",
                 "--out", str(out)])
    assert code == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["exit_code"] == 0 and payload["counts"]["active"] == 0
    assert payload["families_run"] == ["CK", "HS", "US", "KC", "DC"]
    assert json.loads(out.read_text())["counts"] == payload["counts"]


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULES:
        assert rid in out


def test_cli_nonzero_on_violations_and_write_baseline(tmp_path, capsys):
    root = _us_root(tmp_path, """
        def stage(width_um):
            area = width_um * width_um
            return area
        """)
    assert main(["--root", str(root), "--rules", "US"]) == EXIT_BITS["US"]
    assert main(["--root", str(root), "--rules", "US",
                 "--write-baseline"]) == 0
    capsys.readouterr()
    assert main(["--root", str(root), "--rules", "US"]) == 0
    assert (root / "analysis_baseline_torch.json").exists()


def test_cli_rejects_unknown_family():
    with pytest.raises(SystemExit):
        main(["--rules", "JP"])


def test_cli_prune_baseline_drops_only_families_that_ran(tmp_path, capsys):
    root = _us_root(tmp_path, "def stage(width):\n    return width\n")
    baseline = root / "analysis_baseline_torch.json"
    baseline.write_text(json.dumps({"entries": [
        {"rule": "US01", "path": "src/repro_torch/core/periphery.py",
         "snippet": "gone = 1", "justification": "stale"},
        {"rule": "LG01", "path": "src/repro_torch/kernels/x.py",
         "snippet": "whatever", "justification": "not re-checked"},
    ]}), encoding="utf-8")
    assert main(["--root", str(root), "--rules", "US",
                 "--prune-baseline"]) == 0
    assert "pruned 1 stale" in capsys.readouterr().out
    kept = json.loads(baseline.read_text())["entries"]
    assert [e["rule"] for e in kept] == ["LG01"]


def test_prune_baseline_keeps_matching_entries(tmp_path, capsys):
    root = _us_root(tmp_path, """
        def stage(width):
            area = width * width
            return area
        """)
    assert main(["--root", str(root), "--rules", "US",
                 "--write-baseline"]) == 0
    capsys.readouterr()
    assert main(["--root", str(root), "--rules", "US",
                 "--prune-baseline"]) == 0
    assert "pruned 0 stale" in capsys.readouterr().out
    assert main(["--root", str(root), "--rules", "US"]) == 0


def test_live_port_clean_against_committed_baseline():
    report = run_analysis(ROOT, with_docs=True)
    assert report.findings == [], report.format_text()
    assert report.stale_baseline == []
    for e in Baseline.load(ROOT / "analysis_baseline_torch.json").entries:
        assert e["justification"] and not e["justification"].startswith(
            "TODO"), e


def test_ast_tier_imports_neither_torch_nor_jax():
    code = ("import sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "code = main(['--docs'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro', 'numpy'))\n"
            "print(code, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True,
                         cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stdout


# --------------------------------------------------- semantic tier: LG
@pytest.fixture(scope="module")
def lg_static():
    return lg.check_static(Project(ROOT))


def test_lg01_every_static_profile_in_hopper_limits(lg_static):
    findings, stats = lg_static
    assert findings == [], [f.format() for f in findings]
    assert stats["profiles"] > 500 and stats["launches"] > stats["profiles"]
    # the guards' limits one past, refused by the wrappers
    assert stats["refused"] >= 8
    labels = {p.label.split(":")[0] for p in lg.static_profiles()}
    from repro_torch.configs import base
    for arch in base.list_archs():    # the xLSTM launches no kernel
        if base.get_config(arch).family != "ssm":
            assert {arch, f"{arch}/reduced"} <= labels
    cells = {p.label.split(":")[1] for p in lg.static_profiles()
             if p.label.startswith("hymba-1.5b:")}
    assert {"long_500k", "train_4k", "serve", "ragged65"} <= cells


@pytest.mark.parametrize("unguarded,labels", [
    ("flash_attention_bwd", ("limit:B*H=65536", "limit:S=2097152,D=64")),
    ("ssm_scan_bwd", ("limit:B=1,S=4194241",)),
], ids=["attention-bwd-grid-y", "scan-bwd-chunks"])
def test_lg01_fires_where_a_wrapper_guard_is_missing(monkeypatch, unguarded,
                                                     labels):
    """Without the attention backward's launch check a shape the forward
    refuses reaches dim3(n_kt, B*K), and the bf16 D = 64 one's query tiles
    plus combine rows pass 65,535; without the scan wrapper's guard a long
    S reaches dim3(nblk, K, B): LG01."""
    from repro_torch.kernels import ssm_scan as kssm
    if unguarded == "flash_attention_bwd":
        monkeypatch.setattr(lg, "launch_refuses", lambda *a: False)
    else:
        monkeypatch.setattr(kssm, "_check_grid", lambda B, S=0: None)
    findings, _ = lg.check_static(Project(ROOT))
    for label in labels:
        assert [f for f in findings if label + " " in f.message], label
    assert findings and all(f.rule == "LG01" for f in findings)


def test_lg01_two_warpgroup_packed_tile_guard():
    from repro_torch.kernels import flash_attention as kflash
    C, _ = lg.cu_constants(ROOT)
    shape = dict(B=1, H=1, K=1, S=64 * 65536 + 1, Sk=64 * 65536 + 1, D=128,
                 Dv=128, bf16=1)
    broken = [b for launch in lg.geometry("flash_attention_bwd", shape, C)
              for b in lg.limits_broken(launch)]
    assert any("0xFFFF" in b for b in broken)
    with pytest.raises(ValueError, match="16 bits"):
        kflash._check_grid(1, 1, shape["S"], 128, 128, torch.bfloat16,
                           backward=True)
    kflash._check_grid(1, 1, 64 * 65536, 128, 128, torch.bfloat16,
                       backward=True)


def test_lg_backward_launch_checks_its_grids_before_the_first_launch():
    """``launch_refuses`` models the attention backward's launch function:
    each branch returns cudaErrorInvalidConfiguration on a grid past
    kMaxGridY on y before its first ``<<<``."""
    src = _read(f"{lg.CSRC}/flash_attention_bwd.cu")
    body = src[src.index("cudaError_t launch(const void* q"):]
    body = body[:body.index("\n}\n")]
    bf16, f32 = body.split("return cudaGetLastError();\n  }", 1)
    for branch in (bf16, f32):
        refuse = branch.index("return cudaErrorInvalidConfiguration")
        assert "kMaxGridY" in branch[:refuse]
        assert refuse < branch.index("<<<")
    C, _ = lg.cu_constants(ROOT)
    assert C["kMaxGridY"] == lg.MAX_GRID_YZ
    shape = dict(B=1, H=1, K=1, S=64 * 32768, Sk=64 * 32768, D=64, Dv=64,
                 bf16=1)
    launches = lg.geometry("flash_attention_bwd", shape, C)
    assert lg.launch_refuses("flash_attention_bwd", launches, C)
    shape["S"] = shape["Sk"] = 64 * 32767
    launches = lg.geometry("flash_attention_bwd", shape, C)
    assert not lg.launch_refuses("flash_attention_bwd", launches, C)
    assert not any(lg.limits_broken(launch) for launch in launches)


def test_lg_constants_parsed_from_the_sources(tmp_path):
    C, missing = lg.cu_constants(ROOT)
    assert missing == []
    assert (C["kBQ"], C["kBK"], C["kThreadsTC"], C["kTileBytes"],
            C["kSumHeadsBlocks"], C["kThreads3"] // (1 << C["kLogG3"])) == \
        (64, 64, 128, 8192, 512, 32)
    _, missing = lg.cu_constants(tmp_path)
    assert "retention.cu:kBlock" in missing


def test_lg05_spec_complete(lg_static):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssm_scan as kssm
    inst = lg.instantiations(ROOT)
    assert inst["flash_attention"] == inst["flash_attention_bwd"] == \
        set(kflash.HEAD_DIM_PAIRS)
    assert inst["ssm_scan"] == inst["ssm_scan_bwd"] == set(kssm.STATE_SIZES)
    profiled = {(p.lib, p.route) for p in lg.card_profiles()}
    for lib, routes in lg.required_routes().items():
        assert {(lib, r) for r in routes} <= profiled
    # 70 routes before the bf16 (96, 96) backward left mma.sync's one route
    # (per-head partials) for the two-warpgroup pair's three branches
    assert len(profiled) == 72


def test_lg_two_warpgroup_pair_at_96():
    """The bf16 (96, 96) backward on the two-warpgroup pair: LG01's
    geometry at phi-3-vision-4.2b's training shape (one dK/dV block a key
    tile and query head, the blocks storing dK and dV: no combine blocks in
    the dQ launch), its shared memory (three 32-column slabs a row take
    what 1.5 64-column ones would) within the card's limit, its packed q
    tile refused one past 16 bits by the wrapper; and LG05's card profiles
    on its one-head, summed-heads and partials-plus-combine branches."""
    from repro_torch.kernels import flash_attention as kflash
    C, _ = lg.cu_constants(ROOT)
    shape = dict(B=4, H=32, K=32, S=1128, Sk=1128, D=96, Dv=96, bf16=1)
    launches = lg.geometry("flash_attention_bwd", shape, C)
    assert [launch.kernel for launch in launches] == [
        "delta_kernel_bf16<96>", "dkdv_kernel_wg2<96,96>",
        "dq_kernel_wg2<96,96>"]
    dkdv, dq = launches[1:]
    assert dkdv.grid == (18 * 4 * 32, 1, 1) and dq.grid == (18 * 4 * 32, 1, 1)
    assert dkdv.smem == dq.smem == 4 * 3 * 8192 + 4 * (2 * 64 * 64
                                                       + 2 * 3 * 64) + 1024
    assert dkdv.smem <= lg.MAX_DYNAMIC_SMEM and dkdv.threads == 256
    assert not any(lg.limits_broken(launch) for launch in launches)
    # GQA under SUM_HEADS_BLOCKS dK/dV blocks: the combine's blocks follow
    gqa = lg.geometry("flash_attention_bwd", dict(shape, B=1, H=8, K=2), C)
    assert gqa[2].grid[0] > 18 * 8
    for S, ok in ((64 * 65536, True), (64 * 65536 + 1, False)):
        big = dict(shape, B=1, H=1, K=1, S=S, Sk=S)
        assert any("0xFFFF" in b for launch in lg.geometry(
            "flash_attention_bwd", big, C)
            for b in lg.limits_broken(launch)) is not ok
        prof = lg.ShapeProfile("limit", "flash_attention_bwd",
                               tuple(big.items()))
        assert lg.wrapper_accepts(prof) is ok
    assert kflash.backward_kernel(96, 96, torch.bfloat16)[0] == \
        "dkdv_kernel_wg2"
    profiled = {p.route for p in lg.card_profiles()
                if p.lib == "flash_attention_bwd"}
    want = {f"dkdv_kernel_wg2<96,96>:{b}"
            for b in ("direct", "sum", "partials")}
    assert want <= profiled and want <= lg.required_routes()[
        "flash_attention_bwd"]
    assert not any(r.startswith("dkdv_kernel_tc<96,96>") for r in profiled)


def test_lg05_fires_on_an_unprofiled_pair_and_library(monkeypatch):
    from repro_torch.kernels import flash_attention as kflash
    monkeypatch.setattr(kflash, "HEAD_DIM_PAIRS",
                        kflash.HEAD_DIM_PAIRS + ((48, 48),))
    real = lg.card_profiles
    monkeypatch.setattr(lg, "card_profiles", lambda: [
        p for p in real() if p.lib != "retention"
        and not (p.lib == "flash_attention" and p.s["D"] == 96)])
    msgs = [f.message for f in lg._check_spec(Project(ROOT))]
    assert any("library retention has no card profile" in m for m in msgs)
    assert any("(48, 48)" in m for m in msgs)         # not instantiated
    assert any("flash_kernel_wg<96,96>" in m for m in msgs)


def test_lg05_on_a_route_seen_launched():
    p = lg.card_profiles()[0]
    assert lg.check_routes_seen([(p.lib, p.route, "src/x.py", 3)]) == []
    found = lg.check_routes_seen([("flash_attention", "flash_kernel_wg<8,8>",
                                   "src/x.py", 3)])
    assert [f.rule for f in found] == ["LG05"]


def _launch_args(lib, s):
    """A launch's argument tuple with the shape's integers at their
    LAUNCH_ARGTYPES positions (pointers 0 or 1)."""
    from repro_torch.kernels import build
    args = [0] * len(build.LAUNCH_ARGTYPES[lib])
    for name, i in capture.SHAPE_ARGS[lib].items():
        args[i] = s.get(name, 0)
    return tuple(args)


def test_capture_routes_round_trip_every_card_profile():
    for p in lg.card_profiles():
        got = lg.route(p.lib, capture.shape_of(p.lib, _launch_args(p.lib,
                                                                   p.s)))
        assert got == p.route, (p.lib, p.label)


def test_capture_records_a_launch_and_its_port_call_site(monkeypatch):
    from repro_torch.kernels import build
    seen = []
    monkeypatch.setattr(build, "launch", lambda name, *a: seen.append(name))
    from repro_torch.kernels import retention as kret
    s = {"B": 3, "n_steps": 480}
    with capture.capture_launches(ROOT) as caps:
        build.launch("retention", *_launch_args("retention", s))
    assert seen == ["retention"]
    (cap,) = caps
    assert (cap.library, cap.route) == ("retention", "retention_kernel")
    assert dict(cap.shape) == s
    assert kret.retention_batch.launches >= 0


def test_guarded_buffers_catch_gaps_and_guard_writes():
    """LG02 / LG03's machinery on CPU tensors: the sentinel is a NaN no
    arithmetic makes, unwritten elements count, a write past the end
    shows in the guard band."""
    for dtype in (torch.float32, torch.bfloat16):
        nan = (torch.zeros(1, dtype=dtype) / 0)
        bits = nan.view(torch.int32 if dtype == torch.float32
                        else torch.int16).item()
        g = lg.Guarded(10, dtype, "cpu", "sentinel")
        assert bits != g.sentinel
        assert torch.isnan(g.interior.float()).all()
        assert g.unwritten() == 10 and not g.guards_changed()
        g.interior[:7] = 1.0
        assert g.unwritten() == 3 and not g.guards_changed()
        g.buf[g.guard + 10] = 2.0
        assert g.guards_changed()
    x = torch.arange(5.0)
    gi = lg.Guarded(5, torch.float32, "cpu", "nan", x)
    assert torch.equal(gi.interior, x) and not gi.interior_changed()
    assert torch.isnan(gi.buf[:gi.guard]).all()
    gi.interior[0] = 9.0
    assert gi.interior_changed()
    assert gi.guard * 4 >= 64 * 1024


def test_card_profiles_cover_the_issue_shapes():
    profs = lg.card_profiles()
    assert {p.s["B"] for p in profs if p.lib == "retention"} == \
        {1, 120, 2809}
    attn = [p.s for p in profs if p.lib == "flash_attention"]
    assert {s["S"] for s in attn} == {1, 65, 333}
    assert any(s["K"] == 1 and s["H"] > 1 for s in attn)
    assert any(s["window"] and s["sink"] and s["H"] > s["K"] for s in attn)
    bwd = {p.route.rsplit(":", 1)[-1] for p in profs
           if p.lib == "flash_attention_bwd" and "wg2" in p.route}
    assert bwd == {"sum", "partials", "direct"}
    scans = [p.s for p in profs if p.lib.startswith("ssm_scan")]
    assert any(s["di"] % 32 for s in scans)


# --------------------------------------------------- semantic tier: DT
def test_dt_live_entries_clean_on_the_cpu():
    findings = dt.check(Project(ROOT), "cpu")
    assert findings == [], [f.format() for f in findings]
    assert len(dt.ENTRIES) == 7


def test_dt01_flags_float64_on_the_device():
    issues = dt.audit_callable(
        "fixture", lambda x: (x.double() * 2).float(), (torch.ones(4),))
    assert [i["rule"] for i in issues] == ["DT01"]
    assert "float64" in issues[0]["message"]


def test_dt02_flags_a_scalar_leaked_through():
    issues = dt.audit_callable("fixture", lambda x: {"a": x * 2,
                                                     "b": float(x.sum())},
                               (torch.ones(4),))
    assert [i["rule"] for i in issues] == ["DT02"]
    assert dt.audit_callable("fixture", lambda x: {"a": x * 2},
                             (torch.ones(4),)) == []


def test_dt03_flags_narrow_int_accumulation():
    issues = dt.audit_callable(
        "fixture", lambda x: torch.cumsum(x, 0, dtype=torch.int16),
        (torch.ones(8, dtype=torch.int16),), dtype="int16")
    assert [i["rule"] for i in issues] == ["DT03"]


def test_dt04_spec_rot_on_missing_attr(monkeypatch):
    rotted = dt.DtEntry("ghost", "src/repro_torch/core/characterize.py",
                        "no_such_attr", lambda dev: ((), {}))
    monkeypatch.setattr(dt, "ENTRIES", (rotted,))
    findings = dt.check(Project(ROOT), "cpu")
    assert [f.rule for f in findings] == ["DT04"]
    assert "ghost" in findings[0].message


# --------------------------------------------------- semantic tier: RC
def test_rc03_no_compile_site_in_the_port():
    assert rc.compile_sites(Project(ROOT)) == []
    assert rc.check(Project(ROOT)) == []


def test_rc03_overlay_compile_site_caught():
    project = Project(ROOT, overlay={
        "src/repro_torch/core/_rc_probe.py":
            "import torch\n\nprobe = torch.compile(lambda x: x)\n\n\n"
            "@torch.jit.script\ndef scripted(x):\n    return x\n"})
    findings = [f for f in rc.check(project) if f.rule == "RC03"]
    assert sorted(f.line for f in findings) == [3, 7]


def test_rc01_rc02_rc04_fire_on_synthetic_drives(monkeypatch):
    from repro_torch.kernels import build
    calls = {"n": 0}

    def leaky(dev):
        calls["n"] += 1
        for _ in range(6 if calls["n"] == 1 else 1):
            build.BUILDS.inc()

    def broken(dev):
        raise RuntimeError("gone")

    first, repeat, errors = rc.audit_builds("cpu", (leaky, broken))
    assert first[0] == 6 and repeat[0] == 1
    assert errors == [f"driver broken failed on the {which} drive: "
                      f"RuntimeError: gone" for which in ("first", "repeat")]
    monkeypatch.setattr(rc, "audit_builds",
                        lambda dev: ((6, 0), (1, 0), errors))
    rules = sorted(f.rule for f in rc.check(Project(ROOT), "cpu"))
    assert rules == ["RC01", "RC02", "RC04", "RC04"]


def test_rc04_fires_where_only_the_repeat_drive_fails(monkeypatch):
    """The repeat drive serves from the warm caches, so it is not the
    first drive's code: its failure is a finding of its own."""
    calls = {"n": 0}

    def warm_fails(dev):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyError("stale table")

    monkeypatch.setattr(rc, "DRIVERS", (warm_fails,))
    findings = rc.check(Project(ROOT), "cpu")
    assert [f.rule for f in findings] == ["RC04"]
    assert "warm_fails failed on the repeat drive: KeyError" in \
        findings[0].message


def test_rc_drivers_run_on_the_cpu_and_build_nothing():
    first, repeat, errors = rc.audit_builds("cpu")
    assert errors == [] and first == (0, 0) and repeat == (0, 0)


# ------------------------------------------- semantic tier: runner/CLI
def test_runner_semantic_families_lazy_and_reported():
    assert SEMANTIC_FAMILIES == ("LG", "DT", "RC")
    report = run_analysis(ROOT, checks=("US",))
    assert report.families_run == ("US",)


def test_exit_bits_cover_semantic_families():
    assert (EXIT_BITS["LG"], EXIT_BITS["DT"], EXIT_BITS["RC"]) == \
        (32, 64, 128)


def test_findings_module_is_the_ports_own_copy():
    assert findings_mod.__file__ != jax_findings.__file__
    assert "repro_torch" in Path(findings_mod.__file__).parts
