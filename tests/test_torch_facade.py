"""The rest of the port's compiler façade on the CPU against the JAX
reference: ``Macro``'s emitters (SPICE netlist, floorplan with DRC/LVS,
Verilog, Liberty, LEF, ``write_all``), ``Compiler`` (``compile``,
``table``, ``explore``, ``compose``, ``gradient_size``),
``gradient_size_macro`` through ``torch.autograd``, and the deprecated
``core.dse`` shims.

Emitted files are compared byte for byte when both packages get the same
``ppa`` dict (each package's own PPA differs by up to ~1e-6, which can move
a printed last digit); ``report.json`` on keys and values. PPA from
``Compiler.compile``: rtol ``RTOL_PPA``. Sizing: the first gradient within
``RTOL_GRAD_FIRST`` of ``jax.grad``'s, the 200-step result within
``RTOL_GRAD``. ``python tests/test_torch_facade.py`` prints the measured
gaps.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import gainsight as jgainsight
from repro_torch import api
from repro_torch.api import Compiler, MacroConfig
from repro_torch.core import bitcells, gainsight, layout, netlist
from repro_torch.core import characterize as chz

CPU = "cpu"
# Compiler.compile's PPA against the reference's (the characterization's
# parity; measured 4.9e-7 on gc_ossi 64x128)
RTOL_PPA = 2e-6
# d loss / d log w at the bitcell's own sizing against jax.grad, and the
# 200-step sizing result (measured: <= 2.0e-7 and <= 2.1e-7 on the configs
# below; float32 exp/log round apart in the two packages)
RTOL_GRAD_FIRST = 1e-5
RTOL_GRAD = 1e-4

# every bitcell with and without the write-wordline level shifter at a
# small array, plus a column-muxed deep macro and a banked one
EMIT_CASES = [dict(mem_type=mt, word_size=16, num_words=32, level_shift=ls)
              for mt in bitcells.BITCELLS for ls in (False, True)] + [
    dict(mem_type="gc_ossi", word_size=16, num_words=512, level_shift=True),
    dict(mem_type="sram6t", word_size=8, num_words=256, banks=2),
]
SIZING_CASES = [dict(mem_type="gc_ossi", word_size=64, num_words=128),
                dict(mem_type="gc_sisi", word_size=64, num_words=128),
                dict(mem_type="gc_sisi", word_size=32, num_words=256,
                     level_shift=True),
                dict(mem_type="gc_osos_hvt", word_size=16, num_words=64,
                     level_shift=True),
                dict(mem_type="sram6t", word_size=32, num_words=64)]


def _case_id(kw):
    return "-".join(f"{v}" for v in kw.values())


def _both_macros(kw):
    """The port's Macro with its own CPU PPA, and the reference's Macro
    given the same PPA dict."""
    cfg = MacroConfig(**kw)
    ppa = chz.characterize_config(cfg, device=CPU)
    return api.Macro(config=cfg, ppa=ppa), \
        japi.Macro(config=japi.MacroConfig(**kw), ppa=ppa)


def _max_rel(got, want) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-300)
               for k in want)


# ------------------------------------------------------------------ emitters
@pytest.mark.parametrize("kw", EMIT_CASES, ids=_case_id)
def test_emitters_byte_equal_with_the_same_ppa(kw):
    got, want = _both_macros(kw)
    assert got.verilog() == want.verilog()
    assert got.lib() == want.lib()
    assert got.lef() == want.lef()
    assert got.netlist()[1] == want.netlist()[1]


def test_corner_table_macro_emits_as_jax():
    """A macro picked from a corner table emits the same Verilog and
    Liberty as the reference's emitters given its PPA."""
    space = api.design_space(word_sizes=(16,), num_words=(32,))
    table = api.DesignTable.build(space, corners=["nominal", "hot"],
                                  device=CPU)
    macro = table.best("area_um2")
    want = japi.Macro(config=japi.MacroConfig(
        **dataclasses.asdict(macro.config)), ppa=macro.ppa)
    assert f"module {macro.name}" in macro.verilog()
    assert macro.verilog() == want.verilog()
    assert macro.lib() == want.lib()


@pytest.mark.parametrize("kw", EMIT_CASES, ids=_case_id)
def test_netlist_floorplan_and_checks_equal_jax(kw):
    got, want = _both_macros(kw)
    nl, jnl = got.netlist()[0], want.netlist()[0]
    assert nl.top == jnl.top
    assert [(i.name, i.cell, i.ports) for i in nl.instances] == \
        [(i.name, i.cell, i.ports) for i in jnl.instances]
    assert nl.nets == jnl.nets
    fp, jfp = got.layout(), want.layout()
    assert [(r.name, r.kind, r.x, r.y, r.w, r.h) for r in fp.rects] == \
        [(r.name, r.kind, r.x, r.y, r.w, r.h) for r in jfp.rects]
    assert (fp.width, fp.height) == (jfp.width, jfp.height)
    from repro.core import layout as jlayout
    assert layout.drc_check(fp) == jlayout.drc_check(jfp) == []
    assert layout.lvs_check(got.config, fp, nl) == \
        jlayout.lvs_check(want.config, jfp, jnl) == []


def test_checks_catch_broken_layouts():
    """DRC and LVS find what they are for: an off-grid shape, an overlap, a
    missing block, a cell count and a floating net."""
    cfg = MacroConfig(mem_type="gc_sisi", word_size=16, num_words=32)
    nl, _ = netlist.build_netlist(cfg)
    fp = layout.build_floorplan(cfg)
    fp.rects.append(layout.Rect("stray", "decoder", 6.0012, 6.0, 1.0, 1.0))
    errs = layout.drc_check(fp)
    assert any(e.startswith("OFFGRID stray") for e in errs)
    assert any(e.startswith("OVERLAP") for e in errs)
    fp.rects = [r for r in fp.rects if r.name not in ("dec_w", "cell_0_0")]
    nl.add("Xdangling", "inv", IN="nowhere", OUT="dout0", VDD="vdd",
           GND="gnd")
    lvs = layout.lvs_check(cfg, fp, nl)
    assert "MISSING_BLOCK dec_w" in lvs
    assert any(e.startswith("CELLCOUNT") for e in lvs)
    assert "FLOATING nowhere" in lvs


@pytest.mark.parametrize("mt", ["gc_sisi", "gc_ossi", "sram6t"])
def test_write_all_matches_jax(tmp_path, mt):
    """The full flow into a directory: every file byte-equal to the
    reference's given the same PPA, the report equal, DRC and LVS clean,
    and the Macro's PPA reused, not re-characterized."""
    got, want = _both_macros(dict(mem_type=mt, word_size=32, num_words=64,
                                  level_shift=(mt != "sram6t")))
    n = api.characterize_call_count()
    rep = got.write_all(tmp_path / "port")
    jrep = want.write_all(tmp_path / "jax")
    assert api.characterize_call_count() == n
    assert rep["characterization"] is got.ppa
    assert rep["drc_clean"] and rep["lvs_clean"]
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {p.rsplit(".", 1)[1] for p in files} == \
        {"sp", "v", "lib", "lef", "json"}
    for name in files:
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        if name.endswith(".json"):
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name
    assert {k: v for k, v in rep.items() if k != "characterization"} == \
        {k: v for k, v in jrep.items() if k != "characterization"}


# ------------------------------------------------------------------ Compiler
@pytest.mark.parametrize("op", [None, "hot", "low_vdd"])
def test_compiler_compile_matches_jax(op):
    kw = dict(mem_type="gc_ossi", word_size=64, num_words=128)
    m = Compiler(device=CPU).compile(op=op, **kw)
    jm = japi.Compiler().compile(op=op, **kw)
    assert m.config == MacroConfig(**kw) and m.name == jm.name
    assert set(m.ppa) == set(jm.ppa)
    assert all(isinstance(v, float) for v in m.ppa.values())
    gap = _max_rel(m.ppa, jm.ppa)
    print(f"Compiler.compile({op}) vs JAX: max rel {gap:.3e}")
    assert gap <= RTOL_PPA
    assert m.family == jm.family == "os-si"
    assert m.retention_s == m.ppa["retention_s"]
    # the PPA-free files are byte-equal from each package's own PPA too
    assert m.lef() == jm.lef() and m.netlist()[1] == jm.netlist()[1]
    again = Compiler(device=CPU).compile(m.config, op=op, word_size=32)
    assert again.config == MacroConfig(**{**kw, "word_size": 32})


def test_compiler_validation():
    with pytest.raises(KeyError):
        Compiler(mem_types=("gc_sisi", "nosuch"))
    with pytest.raises(KeyError):
        Compiler(device=CPU).compile(mem_type="nosuch", word_size=16,
                                     num_words=16)
    for flag in ("sanitize", "telemetry"):      # ported: they construct
        assert getattr(Compiler(**{flag: True}), flag) is True
    c = Compiler(mem_types=("sram6t", "gc_ossi"), device=CPU)
    assert {cfg.mem_type for cfg in c.design_space()} == {"sram6t",
                                                          "gc_ossi"}


def test_compiler_table_explore_and_compose_match_jax(tmp_path):
    """The façade's methods over one small space: the same labels and picks
    as the reference's Compiler, through the table cache."""
    kw = dict(word_sizes=(16, 64), num_words=(32, 256))
    c, jc = Compiler(device=CPU), japi.Compiler()
    table = c.table(c.design_space(**kw), cache=tmp_path)
    assert len(table) == len(jc.table(jc.design_space(**kw)))
    n = api.characterize_call_count()
    assert len(c.table(c.design_space(**kw), cache=tmp_path)) == len(table)
    assert api.characterize_call_count() == n
    got = c.explore(space=table)
    want = jc.explore(space=jc.design_space(**kw))
    assert got.labels() == want.labels()
    for t, jt in zip(gainsight.TASKS, jgainsight.TASKS):
        rep = c.compose(t, space=table)
        jrep = jc.compose(jt, space=jc.design_space(**kw))
        assert rep.labels() == jrep.labels()
        assert [p.config_idx for lc in rep.best.levels.values()
                for p in lc.picks] == \
            [p.config_idx for lc in jrep.best.levels.values()
             for p in lc.picks]
    assert c.explore().matches(gainsight.TABLE2_EXPECTED) == 7


# ------------------------------------------------------------ gradient sizing
def _jax_objective(kw, area_weight=0.2):
    """The reference's sizing objective (its ``gradient_size_macro``
    closure) as a function of the log widths, for ``jax.grad``."""
    import jax.numpy as jnp

    from repro.core import bitcells as jb
    from repro.core import characterize as jchz
    from repro.core import macro as jm
    from repro.core import periphery as jp
    from repro.core import tech as jtech
    cfg = japi.MacroConfig(**kw)
    base_cell = jb.BITCELLS[cfg.mem_type]
    vec = cfg.to_vector()

    def objective(logw):
        w_read, w_write = jnp.exp(logw)
        cell = base_cell._replace(
            w_read=w_read, w_write=w_write,
            c_sn=base_cell.c_sn + (w_read - base_cell.w_read) * 1e-15,
            cell_w=base_cell.cell_w * (1 + 0.6 * (
                w_read - base_cell.w_read + w_write - base_cell.w_write)))
        g = {**jm.geometry(vec), "cell": cell}
        area, _ = jm.macro_area(g)
        i_rd = jchz._read_current(cell, g["ls"])
        c_bl, r_bl = jp.bitline_rc(g["rows"], cell.cell_h, cell.w_read)
        t_bl = c_bl * jtech.V_SENSE / jnp.maximum(i_rd, 1e-9)
        i_w = jchz._write_current(cell, g["ls"])
        t_sn = cell.c_sn * jb.sn_high_level(cell, g["ls"]) \
            / jnp.maximum(i_w, 1e-9)
        t = t_bl + t_sn + 0.7 * r_bl * c_bl
        area0, _ = jm.macro_area(jm.geometry(vec))
        return jnp.log(t) + area_weight * (area / area0 - 1.0)

    logw0 = jnp.log(jnp.asarray([float(base_cell.w_read),
                                 float(base_cell.w_write)]))
    return objective, logw0


def _first_gradients(kw):
    import jax
    objective, logw0 = api._sizing_objective(MacroConfig(**kw), 0.2,
                                             torch.device(CPU))
    lw = logw0.detach().requires_grad_(True)
    (got,) = torch.autograd.grad(objective(lw)[0], lw)
    jobjective, jlogw0 = _jax_objective(kw)
    np.testing.assert_array_equal(logw0.numpy(), np.asarray(jlogw0))
    want = np.asarray(jax.jit(jax.grad(jobjective))(jlogw0))
    return got.numpy(), want


@pytest.mark.parametrize("kw", SIZING_CASES, ids=_case_id)
def test_first_sizing_gradient_matches_jax_grad(kw):
    got, want = _first_gradients(kw)
    gap = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"d loss / d log w {_case_id(kw)}: {got} vs jax.grad {want}, "
          f"max rel {gap:.3e}")
    assert gap <= RTOL_GRAD_FIRST


@pytest.mark.parametrize("kw", SIZING_CASES, ids=_case_id)
def test_gradient_size_macro_matches_jax(kw):
    got = Compiler(device=CPU).gradient_size(MacroConfig(**kw))
    want = japi.gradient_size_macro(japi.MacroConfig(**kw))
    assert set(got) == set(want)
    gap = _max_rel(got, want)
    print(f"gradient_size_macro {_case_id(kw)}: max rel {gap:.3e}")
    assert gap <= RTOL_GRAD
    # the widths stay inside the clip (log 0.06, log 0.6 in float32)
    assert 0.06 * (1 - 1e-6) <= got["w_read_um"] <= 0.6 * (1 + 1e-6)
    if kw["mem_type"] != "sram6t":
        # (an SRAM cell's storage cap is the width delta alone, so its
        # modelled delay can cross zero: in the reference too, gap above)
        assert got["speedup"] > 1.0
    short = api.gradient_size_macro(MacroConfig(**kw), steps=3, lr=0.01,
                                    area_weight=0.5, device=CPU)
    jshort = japi.gradient_size_macro(japi.MacroConfig(**kw), steps=3,
                                      lr=0.01, area_weight=0.5)
    assert _max_rel(short, jshort) <= RTOL_GRAD


# ------------------------------------------------------------------- shims
def test_dse_shims_warn_and_forward():
    from repro_torch.core import dse
    space = api.design_space(word_sizes=(16, 64), num_words=(32, 256))
    with pytest.warns(DeprecationWarning, match="repro_torch.core.dse"):
        assert dse.design_space(word_sizes=(16, 64),
                                num_words=(32, 256)) == space
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = dse.evaluate_space(space, device=CPU)
        table = api.DesignTable.from_configs(space, device=CPU)
        for k, v in table.metrics.items():
            np.testing.assert_array_equal(res[k], v)
        report = api.explore(space=table, device=CPU)
        for t in gainsight.TASKS:
            label, picks = dse.select_level(space, res, t.l1)
            assert label == report.selections[t.task_id]["L1"].label
            assert [p["config_idx"] for p in picks] == \
                [p.config_idx for p in report.selections[t.task_id]["L1"]
                 .picks]
            b, pick = t.l1.buckets[0], \
                report.selections[t.task_id]["L1"].picks[0]
            fam, row = dse.select_bucket(space, res, b)
            assert (fam, int(row)) == (pick.family, pick.config_idx)
            np.testing.assert_array_equal(
                dse.shmoo(space, res, b.f_hz, b.lifetime_s),
                table.shmoo(b.f_hz, b.lifetime_s))
            np.testing.assert_array_equal(
                dse.feasible_mask(res, b.f_hz, b.lifetime_s),
                table.shmoo(b.f_hz, b.lifetime_s))
        assert dse.tech_of(space[0]) == api.family_of(space[0].mem_type)
        pts = np.stack([res["area_um2"], res["p_leak_w"]], axis=1)
        np.testing.assert_array_equal(
            dse.pareto_front(pts), api.pareto_mask(pts))
        cfg = MacroConfig(mem_type="gc_sisi", word_size=64, num_words=128)
        assert dse.gradient_size_macro(cfg, steps=2, device=CPU) == \
            api.gradient_size_macro(cfg, steps=2, device=CPU)


if __name__ == "__main__":
    for kw in SIZING_CASES:
        got, want = _first_gradients(kw)
        print(f"first sizing gradient {_case_id(kw)}: max rel "
              f"{np.max(np.abs(got - want) / np.abs(want)):.3e} (gate "
              f"{RTOL_GRAD_FIRST})")
        g = api.gradient_size_macro(MacroConfig(**kw), device=CPU)
        jg = japi.gradient_size_macro(japi.MacroConfig(**kw))
        print(f"gradient_size_macro {_case_id(kw)}: max rel "
              f"{_max_rel(g, jg):.3e} (gate {RTOL_GRAD})")
    for op in (None, "hot", "cold", "low_vdd"):
        kw = dict(mem_type="gc_ossi", word_size=64, num_words=128)
        m = Compiler(device=CPU).compile(op=op, **kw)
        jm = japi.Compiler().compile(op=op, **kw)
        print(f"Compiler.compile at {op or 'nominal'}: max rel "
              f"{_max_rel(m.ppa, jm.ppa):.3e} (gate {RTOL_PPA})")
    same = sum(a.verilog() == b.verilog() and a.lib() == b.lib()
               and a.lef() == b.lef() and a.netlist()[1] == b.netlist()[1]
               for a, b in map(_both_macros, EMIT_CASES))
    print(f"emitters byte-equal with the same PPA: {same}/{len(EMIT_CASES)}")
