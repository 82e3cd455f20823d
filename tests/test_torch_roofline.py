"""The port's roofline analysis (``analysis/roofline.py``,
``perf_report.py``, ``experiments_doc.py``) against the reference's, on
shared inputs:

- ``model_flops`` and ``inner_scan_correction`` bit for bit for every
  arch x shape x {256, 512} chips;
- ``markdown_table``, ``extrapolate_cell``, ``analyze_all``, ``_terms``
  and ``report`` on the same synthetic dry-run records written into
  ``tmp_path`` (both modules' ``DRYRUN``/``RESULTS`` monkeypatched
  there): equal to the reference's once the reference's hardware
  constants are the port's and its ``inner_scan_correction`` is taken
  out, the one term the port leaves out (its eager trace counts every
  trip of the loops the correction stands for); and the reference's own
  result less its correction within 1e-12;
- ``obs_scorecard`` on a JSON the test writes, and the experiments
  document, which holds no TPU figure.
"""
import json

import pytest

from repro.analysis import perf_report as jperf
from repro.analysis import roofline as jroof
from repro.configs import get_config as jax_get_config
from repro.configs.shapes import get_shape as jax_get_shape

from repro_torch.analysis import experiments_doc as tdoc
from repro_torch.analysis import perf_report as tperf
from repro_torch.analysis import roofline as troof
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, cell_applicable, get_shape
from repro_torch.obs.export import scorecard_markdown


@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_scan_correction_equal_the_reference(arch, chips):
    for shape in SHAPES:
        ours = (get_config(arch), get_shape(shape.name), chips)
        ref = (jax_get_config(arch), jax_get_shape(shape.name), chips)
        assert troof.model_flops(*ours) == jroof.model_flops(*ref)
        assert troof.inner_scan_correction(*ours) == \
            jroof.inner_scan_correction(*ref)


def test_hardware_constants_are_the_cards():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 50e9)


def _record(arch, shape, mesh, tag, seed):
    """A synthetic ok record; numbers grow with depth (u1 < u2 < full)."""
    depth = {"u1": 1, "u2": 2}.get(tag.replace("__pbase", ""), 7)
    base = 1000 + 37 * seed
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "policy": "baseline" if "pbase" in tag else "auto",
            "flops": float(base * 10 ** 9 + depth * 3 * 10 ** 11),
            "bytes_accessed": float(base * 10 ** 6 + depth * 7 * 10 ** 8),
            "collectives": {"all-gather": {"count": depth,
                                           "bytes": base + depth * 4096},
                            "all-reduce": {"count": 1, "bytes": 512 * seed}},
            "memory": {"argument_size_in_bytes": base * 10 ** 6,
                       "output_size_in_bytes": 10 ** 6,
                       "temp_size_in_bytes": seed * 10 ** 8}}


@pytest.fixture
def records(tmp_path, monkeypatch):
    """Synthetic records of every applicable cell (16x16; full, u1, u2,
    each with and without the baseline tag, a few cells without u1/u2, one
    failed), read by both packages' modules from ``tmp_path``; both write
    there; the reference's constants are the port's and its scan
    correction is taken out (``original`` keeps it)."""
    dry = tmp_path / "dryrun"
    dry.mkdir()
    seed = 0
    for arch in ARCHS:
        for shape in SHAPES:
            if not cell_applicable(get_config(arch), shape)[0]:
                continue
            seed += 1
            for tag in ("", "u1", "u2", "__pbase", "u1__pbase", "u2__pbase"):
                if seed % 9 == 0 and tag.startswith("u"):
                    continue        # full-trace method for these cells
                rec = _record(arch, shape.name, "16x16", tag, seed)
                if seed == 5 and tag == "":
                    rec = {"arch": arch, "shape": shape.name,
                           "mesh": "16x16", "status": "error",
                           "error": "RuntimeError: synthetic"}
                (dry / f"{arch}__{shape.name}__16x16{tag}.json").write_text(
                    json.dumps(rec))
    for mod in (troof, jroof):
        monkeypatch.setattr(mod, "DRYRUN", dry)
        monkeypatch.setattr(mod, "RESULTS", tmp_path)
    for mod in (tperf, jperf, tdoc):
        monkeypatch.setattr(mod, "RESULTS", tmp_path)
    original = jroof.inner_scan_correction
    for mod in (jroof, jperf):
        monkeypatch.setattr(mod, "PEAK_FLOPS", troof.PEAK_FLOPS)
        monkeypatch.setattr(mod, "HBM_BW", troof.HBM_BW)
        monkeypatch.setattr(mod, "ICI_BW", troof.LINK_BW)
    monkeypatch.setattr(jroof, "inner_scan_correction",
                        lambda *_: {"flops": 0.0, "bytes": 0.0})
    return tmp_path, original


def _without_method(rec):
    """A record without its method's text, and without the mitigation's:
    the port's names inter-node links where the reference names the TPU
    pods' data-center network."""
    return {k: v for k, v in rec.items() if k not in ("method",
                                                      "mitigation")}


def test_extrapolate_cell_equals_the_reference_less_its_correction(records):
    _, original = records
    n = 0
    for arch in ARCHS:
        for shape in SHAPES:
            ours = troof.extrapolate_cell(arch, shape.name)
            ref = jroof.extrapolate_cell(arch, shape.name)
            if ref is None or ref.get("status") == "error":
                assert ours == ref
                continue
            assert _without_method(ours) == _without_method(ref)
            assert ours["scan_correction"] == {"flops": 0.0, "bytes": 0.0}
            assert "no scan correction" in ours["method"]
            corr = original(jax_get_config(arch),
                            jax_get_shape(shape.name), 256)
            ref_flops = ref["flops"] + corr["flops"]
            assert abs((ref_flops - corr["flops"]) - ours["flops"]) <= \
                1e-12 * ref_flops
            n += 1
    assert n > 30


def test_analyze_all_and_markdown_table_equal_the_reference(records):
    tmp_path, _ = records
    ours = troof.analyze_all()
    ours_json = json.loads((tmp_path / "roofline.json").read_text())
    ref = jroof.analyze_all()
    key = lambda r: (r["arch"], r["shape"])  # noqa: E731 (ARCHS' orders differ)
    assert [_without_method(r) for r in sorted(ours, key=key)] == \
        [_without_method(r) for r in sorted(ref, key=key)]
    assert ours_json == json.loads(json.dumps(ours))
    for r in ours:
        if "dominant" in r:
            assert r["mitigation"] == troof.MITIGATIONS[r["dominant"]]
    assert troof.MITIGATIONS.keys() == jroof.MITIGATIONS.keys()
    assert troof.markdown_table(ours) == jroof.markdown_table(ours)
    assert troof.markdown_table(ref) == jroof.markdown_table(ref)
    # a skipped cell and an error record take the same rows
    assert "skipped" in troof.markdown_table(ours)


def test_terms_and_report_equal_the_reference(records, monkeypatch):
    tmp_path, original = records
    for arch, shape, _ in tperf.CELLS:
        for tag in ("", "__pbase"):
            assert tperf._terms(arch, shape, tag) == \
                jperf._terms(arch, shape, tag)
    ours = tperf.report()
    ours_json = (tmp_path / "perf_report.json").read_text()
    assert ours == jperf.report()
    assert ours_json == (tmp_path / "perf_report.json").read_text()
    assert ours.count("\n**") >= 2
    # the reference's own optimized terms carry its correction; the port's
    # are those less it
    monkeypatch.setattr(jroof, "inner_scan_correction", original)
    for arch, shape, _ in tperf.CELLS:
        ref = jperf._terms(arch, shape, "")
        if ref is None:
            continue
        corr = original(jax_get_config(arch), jax_get_shape(shape), 256)
        ours = tperf._terms(arch, shape, "")
        for key, c in (("flops", "flops"), ("bytes", "bytes")):
            assert abs(ref[key] - corr[c] - ours[key]) <= 1e-12 * ref[key]


def test_obs_scorecard_renders_a_given_file(tmp_path):
    bench = {"meta": {"requests": 33277, "horizon_s": 600.0},
             "per_tenant": {"chat": {"n": 10, "ttft_p95": 0.25}},
             "calibration": {"ticks": 6, "accuracy_rate": 0.83}}
    path = tmp_path / "obs.json"
    path.write_text(json.dumps(bench))
    assert tperf.obs_scorecard(path) == scorecard_markdown(
        bench["meta"], bench["per_tenant"], bench["calibration"],
        title="Serving observability scorecard (obs.json)")
    assert tperf.obs_scorecard(None) == ""
    assert tperf.obs_scorecard(tmp_path / "missing.json") == ""
    assert "Serving observability scorecard" in \
        tperf.report(obs_path=path)


def test_experiments_doc_writes_the_ports_document(records):
    tmp_path, _ = records
    tdoc.main()
    doc = (tmp_path / "EXPERIMENTS.md").read_text()
    for section in ("§Datasets", "§Paper-validation", "§Dry-run",
                    "§Roofline", "§Perf"):
        assert section in doc
    assert "repro_torch.launch.dryrun --all" in doc
    assert "TPU" not in doc and "v5e" not in doc
    assert "1 failed" in doc and "RuntimeError: synthetic" in doc
    assert troof.markdown_table(troof.analyze_all()) in doc
