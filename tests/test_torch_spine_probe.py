"""``elemental_tpu_torch.kernels.spine_probe``'s source rewrite, on the CPU.

The probe stamps a copy of a committed kernel source with
``%globaltimer`` reads and builds it on the card; the rewrite itself is
text work.  Each mode's current stamps must find every anchor exactly
once in the committed ``csrc/*.cu`` source, so that an edit of a kernel
that moves an anchor fails here and not on the card.  The A/B timing
tool beside it (``kernels/ab_timing.py``) and ``tools/potrf_trial.py``
refuse to run without a card."""
import runpy

import numpy as np
import pytest

from elemental_tpu_torch.kernels import ab_timing, common, spine_probe

KINDS = ["qr", "lu", "potrf"]


def _source(kind):
    return (common.CSRC / spine_probe._PROBES[kind]["source"]).read_text()


@pytest.mark.parametrize("kind", KINDS)
def test_current_stamps_fit_the_committed_source(kind):
    src = _source(kind)
    current = spine_probe._PROBES[kind]["versions"][0]
    for anchor, text in current["stamps"]:
        assert src.count(anchor) == 1, (kind, anchor)
    version, parts, out = spine_probe.stamped_source(kind, src)
    assert version == current["name"]
    assert parts == current["parts"]
    inserted = sum(t.count("PROBE_TS(") - a.count("PROBE_TS(")
                   for a, t in current["stamps"])
    head = out.count("PROBE_TS(") - inserted
    assert inserted >= len(current["stamps"]) and head == 1
    assert "probe_ts(void* dst)" in out
    # the rewrite only inserts: every line of the source survives, in order
    it = iter(out.splitlines())
    assert all(line in it for line in src.splitlines())


@pytest.mark.parametrize("kind", KINDS)
def test_a_source_without_the_anchors_is_refused(kind):
    with pytest.raises(RuntimeError, match=f"no {kind} probe anchors"):
        spine_probe.stamped_source(kind, "#include <cstddef>\n")


def test_potrf_parts_read_only_stamped_slots():
    """Every part of the potrf split starts and ends at a slot that a stamp
    writes, for the block that writes it (0 and 6 both, 1 both, 2 both;
    3 and 4 the chain's, 5 the worker's)."""
    src = _source("potrf")
    for version in spine_probe._PROBES["potrf"]["versions"]:
        slots = {int(t.split("PROBE_TS(")[1].split(")")[0])
                 for _, t in version["stamps"]}
        for dtype_parts in version["parts"].values():
            for role, parts in dtype_parts.items():
                for a, b, _ in parts:
                    assert {a, b} <= slots, (version["name"], role, a, b)
    assert spine_probe.stamped_source("potrf", src)[0].startswith("current")
    # and each version names the columns of its steps in each dtype
    assert {v["name"] for v in spine_probe._PROBES["potrf"]["versions"]} \
        == set(spine_probe._POTRF_NB)


def test_the_fma_potrf_source_still_gets_its_stamps():
    """The probe reads an earlier revision with ``--src``: the FMA version
    of ``potrf_inv.cu`` (the committed source with both dtypes on its FMA
    product and its generation barriers, the anchors that differ) gets
    that version's stamps, and the committed source the current
    version's."""
    src = _source("potrf")
    fma = src
    for now, then in (
            ("smem_prod<true>(S, LS, X, LS, X, LS",
             "smem_mm<true>(S, LS, X, LS, X, LS"),
            ("      if constexpr (!COUNTED) grid_wait_past(a.bar, gen);\n",
             "      grid_wait_past(a.bar, gen);\n"),
            ("      grid_barrier(a.bar);\n    }\n\n    // ---- phase Q",
             "      grid_barrier(a.bar);\n\n    // ---- phase Q"),
            ("    sync_all();\n  }\n}\n", "    grid_barrier(a.bar);\n  }\n}\n")):
        assert fma.count(now) == 1
        fma = fma.replace(now, then)
    assert spine_probe.stamped_source("potrf", fma)[0] == \
        "FMA tiles in both dtypes"


@pytest.mark.parametrize("kind,now,then,version", [
    ("lu", "    const int p = resolve(j, sc);\n",
     "    const int p = resolve(j, par, G, sc);\n",
     "float64 candidates reduced in every warp"),
    ("qr", "      column_barrier(grid, sc, target);\n    }\n",
     "      grid.sync();\n    }\n", "grid.sync in both dtypes")])
def test_the_earlier_panel_spines_still_get_their_stamps(kind, now, then,
                                                         version):
    """``--src`` probes the column loops before the float64 redesign: the
    committed source with its one differing anchor put back (LU: the G
    candidates each warp reduced; QR: grid.sync() closing each column in
    both dtypes) gets that version's stamps."""
    src = _source(kind)
    assert src.count(now) == 1
    name, parts, out = spine_probe.stamped_source(kind,
                                                  src.replace(now, then))
    assert name == version
    assert out.count("PROBE_TS(") > len(parts)


@pytest.mark.parametrize("kind", ["qr", "lu"])
def test_panel_probes_follow_both_dtypes(kind):
    """The qr and lu probes stamp a chunk of a float32 and a float64 panel
    (the float64 one at the example's first panel), each chunk inside its
    panel, and the stamp macro picks the chunk by the kernel's type."""
    probe = spine_probe._PROBES[kind]
    assert set(probe["panel"]) == set(probe["chunk"]) == {"float32",
                                                          "float64"}
    assert probe["panel"]["float64"] == {"qr": (32768, 128),
                                         "lu": (16384, 1024)}[kind]
    for name, (M, k) in probe["panel"].items():
        assert 0 < probe["chunk"][name] < k
    _, _, out = spine_probe.stamped_source(kind, _source(kind))
    assert (f"sizeof(T) == 8 ? {probe['chunk']['float64']} : "
            f"{probe['chunk']['float32']}") in out


def test_potrf_split_means_each_part_over_the_steps():
    """``potrf_split`` on synthetic stamps: block 0's parts advance by 1,
    2, 3, 4 and 5 us a step, block 1's by 2, 3, 4 and 6; the step is 15
    us; the last step, which ends after its P phase, is left out."""
    steps = 10
    ts = np.zeros((2, 64, 8), dtype=np.uint64)
    chain = {0: 0, 1: 1, 2: 3, 3: 6, 4: 10, 6: 15}
    worker = {0: 0, 1: 2, 2: 5, 5: 9, 6: 15}
    for s in range(steps):
        for slot, us in chain.items():
            ts[0, s, slot] = (s * 15 + us) * 1000
        for slot, us in worker.items():
            ts[1, s, slot] = (s * 15 + us) * 1000
    ts[:, steps - 1, 2:] = 0                 # the last step breaks after P
    parts = spine_probe._POTRF_PARTS
    out = spine_probe.potrf_split(ts, parts, steps)
    assert list(out["chain"].values()) == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert list(out["worker"].values()) == [2.0, 3.0, 4.0, 6.0]
    assert out["step_us"] == 15.0


@pytest.mark.parametrize("kernel", ["lu", "qr", "potrf"])
def test_ab_timing_needs_a_card(kernel, capsys):
    """Without a card both modes exit 1 and time nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    assert ab_timing.main([str(common.CSRC), "--kernel", kernel]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_potrf_trial_needs_a_card(capsys):
    """``tools/potrf_trial.py`` exits 1 without a card and builds nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    path = common.CSRC.parents[2] / "tools" / "potrf_trial.py"
    assert runpy.run_path(str(path), run_name="potrf_trial")["main"]() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_ab_timing_qr_residual_of_the_plain_version():
    """``ab_timing.qr_residual``, the gate of ``--kernel qr``, is at
    rounding level for the plain version's factor and far above it for a
    wrong tau."""
    import torch
    from elemental_tpu_torch.kernels import qr_panel_reference
    P = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 70)))
    packed, tau, T = qr_panel_reference(P)
    assert ab_timing.qr_residual(P, packed, tau, T) < 1e-14
    assert ab_timing.qr_residual(P, packed, tau, 2 * T) > 1e-2
