"""A configuration, a mix, a cell and a per-layer metric added as new files
are found by name, without an edit to any file already there."""

import json
import shutil

from perfbench import common, run


def test_new_files_are_found_by_name(tmp_path):
    bd = tmp_path / "perfbench"
    shutil.copytree(common.BENCH_DIR, bd, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = common.benchmark_spec()
    before = {p: p.read_bytes() for p in bd.rglob("*") if p.is_file()}

    cfg = json.loads((bd / "configs" / "clip-vit-b32-int8.json").read_text())
    cfg.update(name="clip-vit-b32-int8-big-bank", bank_rows=1 << 22)
    (bd / "configs" / "clip-vit-b32-int8-big-bank.json").write_text(json.dumps(cfg))
    (bd / "traffic" / "batch64.json").write_text(json.dumps(
        {"arrivals": "closed", "captions": "variants", "batch": 64, "variants": 6, "image_batches": 2}))
    cell = {"name": "clip-vit-b32-int8-big-bank.batch64", "config": "clip-vit-b32-int8-big-bank",
            "traffic": "batch64", "driver": "detect_closed", "chips": 1, "why": "a test cell",
            "check": {"rows": 8, "limits": {"score_gap": 0.1}}}
    (bd / "workloads" / f"{cell['name']}.json").write_text(json.dumps(cell))
    (bd / "metrics" / "bank_rows.big.py").write_text(
        "def read(ctx):\n    return float(ctx.driver.c['bank_rows'])\n")
    spec["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips", "why")})
    spec["end_to_end"][0].setdefault("workloads", []).append(cell["name"])
    spec["per_layer"].append({"name": "bank_rows.big", "unit": "rows", "better": "higher", "source": "program_counter",
                              "layer": "retrieval", "moves": "detect_qps", "workloads": [cell["name"]]})

    assert common.workload(cell["name"], bd)["driver"] == "detect_closed"
    assert common.config("clip-vit-b32-int8-big-bank", bd)["bank_rows"] == 1 << 22
    assert common.mix("batch64", bd)["batch"] == 64
    wanted = common.cell_metrics(spec, cell["name"])
    assert [m["name"] for m in wanted["per_layer"]] == ["bank_rows.big"]
    assert {m["name"] for m in wanted["end_to_end"]} == {"detect_qps", "setup_s"}

    class Ctx:
        class driver:
            c = {"bank_rows": 1 << 22}

    assert run.load_reader("bank_rows.big", bd)(Ctx) == float(1 << 22)
    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data


def test_every_cell_of_the_benchmark_has_its_files():
    spec = common.benchmark_spec()
    names = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        wl = common.workload(w["name"])
        assert wl["config"] == w["config"] in names and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"] == 1 and wl["why"] == w["why"]
        common.mix(w["traffic"])
        got = common.cell_metrics(spec, w["name"])
        assert any(m["name"] == "setup_s" for m in got["end_to_end"]) and len(got["end_to_end"]) >= 2
        assert got["per_layer"]
    for c in spec["configs"]:
        assert common.config(c["name"])["name"] == c["name"]
    for m in spec["per_layer"]:
        assert callable(run.load_reader(m["name"], common.BENCH_DIR))
