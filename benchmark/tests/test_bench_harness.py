"""Tests of the benchmark's harness on the CPU.

    python -m pytest benchmark/tests -q

They cover the loading of entries by name (also from a directory that a
test writes), the trace and roofline arithmetic on synthetic intervals,
the frozen ``min_bytes`` against the program's, the whole-word import
check, a run that finds no card, and one run of a small cell through the
harness's path on the CPU, whose program and frozen reference agree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

from harness import compare as cmp  # noqa: E402
from harness import isolation, roofline, trace  # noqa: E402
from harness.spec import Spec, read_per_layer  # noqa: E402

from small_cells import small_cell  # noqa: E402


def spec():
    return Spec(ROOT / "BENCHMARK.json")


# ------------------------------------------------------------ by name
def test_every_entry_loads_by_name():
    s = spec()
    for name in s.workloads:
        cell = s.cell(name)
        assert cell.config["ndim"] in (2, 3)
        assert "warmup" in cell.traffic
        assert set(cmp.NUMBERS) <= set(cell.limits)
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.per_layer:
            assert callable(s.reader(m.name))
    for m in s.per_layer:
        assert m.moves in {e.name for e in s.end_to_end}


def test_an_entry_added_as_files_loads(tmp_path):
    """A new configuration, traffic, cell, metric and limits are new files
    and new entries only."""
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (bench / sub).mkdir(parents=True)
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "air_cyl_photoi.json").read_text())
    cfg["settings"]["refine_max_dx"] = "3.125e-5"
    (bench / "configs" / "air_cyl_new.json").write_text(json.dumps(cfg))
    traffic = json.loads(
        (BENCH / "traffic" / "live_refinement.json").read_text())
    traffic["whole_steps"] = 5
    (bench / "traffic" / "frozen_mesh.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return rec['steps'] or None\n")
    (bench / "limits" / "cyl_new.json").write_text(json.dumps(
        {"state_gap": 1e-9, "dt_gap": 1e-9, "mesh_gap": 0,
         "cycles_gap": 0}))
    data["configs"].append({"name": "air_cyl_new", "source": "x",
                            "file": "bench/configs/air_cyl_new.json",
                            "reduced": [], "why": "x"})
    data["workloads"].append({"name": "cyl_new", "config": "air_cyl_new",
                              "traffic": "frozen_mesh", "chips": 1,
                              "why": "x"})
    data["per_layer"].append({"name": "steps_seen", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "setup_s",
                              "workloads": ["cyl_new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    s = Spec(tmp_path / "BENCHMARK.json", bench_dir=bench)
    cell = s.cell("cyl_new")
    assert cell.config["settings"]["refine_max_dx"] == "3.125e-5"
    assert cell.traffic["whole_steps"] == 5
    del traffic["window_steps"]
    (bench / "traffic" / "frozen_mesh.json").write_text(json.dumps(traffic))
    with pytest.raises(ValueError, match="window_steps"):
        s.cell("cyl_new")
    assert "steps_seen" in [m.name for m in cell.per_layer]
    seen = next(m for m in s.per_layer if m.name == "steps_seen")
    assert not seen.applies_to("cyl_amr_2048")
    cell.per_layer = [m for m in cell.per_layer if m.name == "steps_seen"]
    got = read_per_layer(s, cell, {"steps": 7})
    assert got == {"steps_seen": {"value": 7, "unit": "steps"}}
    assert read_per_layer(s, cell, {"steps": 0}) == {}
    from harness.sides import cell_argv
    argv = cell_argv(cell, "out/run", "cpu")
    assert "-refine_max_dx=3.125e-5" in argv
    assert any(a.startswith("-input_data%file=") and
               a.endswith("td_air_synthetic.txt") for a in argv)


def test_a_window_is_a_fixed_number_of_whole_cycles():
    from harness.cell import window_steps
    cell = spec().cell("cyl_amr_2048")
    cell.traffic.update(window_steps=70, whole_steps=10)
    assert window_steps(cell, 45, 45) == 70
    assert window_steps(cell, 10, 45) == 20
    assert window_steps(cell, 0.3, 45) == 10
    assert window_steps(cell, 90, 45) == 140


# --------------------------------------------------- trace arithmetic
def test_union_and_idle_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union_seconds(iv) == pytest.approx(3.0)
    assert trace.idle_gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                              (4.0, 5.0)]
    assert trace.idle_gaps([], 0.0, 2.0) == [(0.0, 2.0)]
    assert trace.union_seconds([]) == 0.0


def test_idle_gaps_labelled_by_innermost_span():
    spans = [("photoi", 0.0, 10.0), ("field", 2.0, 4.0)]
    gaps = [(2.5, 3.5), (5.0, 6.0), (11.0, 11.5)]
    got = dict(trace.idle_by_label(gaps, spans))
    assert got == pytest.approx({"field": 1.0, "photoi": 1.0,
                                 "driver": 0.5})


def test_device_idle_reader():
    s = spec()
    read = s.reader("device_idle_pct")
    rec = {"device": {"window_s": 2.0, "busy_s": 0.5}}
    assert read(rec) == pytest.approx(75.0)
    assert read({"device": {"window_s": 2.0, "busy_s": 0.0}}) is None


def test_roofline_reader_on_synthetic_launches():
    s = spec()
    n, nc = 4096, 32
    launches = [("fill_sweep_2d", n, nc, 8), ("sweep_2d", n, nc, 8)]
    bound = (roofline.min_bytes("fill_sweep_2d", n, nc)
             + roofline.min_bytes("sweep_2d", n, nc)) / 3.35e12
    rec = {"device": {"kernels": {"2d": {"launches": launches,
                                         "seconds": 2 * bound},
                                  "3d": {"launches": [], "seconds": 0.0}}}}
    assert s.reader("kernel_roofline_pct.2d")(rec) == pytest.approx(50.0)
    rec["device"]["kernels"]["2d"] = {"launches": [], "seconds": 0.0}
    assert s.reader("kernel_roofline_pct.2d")(rec) is None


def test_kernel_family_of_trace_names():
    assert roofline.kernel_family(
        "void fill_sweep_2d_kernel<double>(double const*, int)") == "2d"
    assert roofline.kernel_family("void sweep_2d_kernel<float>(x)") == "2d"
    assert roofline.kernel_family("sweep_2d_big_kernel<double>") == "2d"
    assert roofline.kernel_family("void fill_3d_direct_kernel<double>()") \
        == "3d"
    assert roofline.kernel_family("void at::native::elementwise_kernel<"
                                  "128, 2>(int)") is None


def test_span_readers():
    s = spec()
    spans = [("fluid", 0.0, 1.0), ("field", 0.6, 0.9), ("fluid", 1.0, 1.5),
             ("epoch", 2.0, 2.4), ("photoi", 3.0, 3.2), ("field", 3.5, 3.6)]
    rec = {"steps": 2, "wall_s": 1.5, "spans": spans, "launches": 10,
           "plan_build_s": 0.1,
           "vcycles": [1, 1, 2], "fmg": [[1, 1, 1], [2, 1, 1]]}
    assert s.reader("wall_ms_per_step")(rec) == pytest.approx(750.0)
    assert s.reader("fluid_ms_per_step")(rec) == pytest.approx(600.0)
    assert s.reader("field_ms_per_solve")(rec) == pytest.approx(200.0)
    assert s.reader("epoch_ms")(rec) == pytest.approx(400.0)
    assert s.reader("photoi_ms_per_update")(rec) == pytest.approx(200.0)
    assert s.reader("launches_per_step")(rec) == pytest.approx(5.0)
    assert s.reader("plan_build_ms_per_step")(rec) == pytest.approx(50.0)
    assert s.reader("vcycles_per_solve")(rec) == pytest.approx(4 / 3)
    assert s.reader("fmg_cycles_per_update")(rec) == pytest.approx(3.5)


# ------------------------------------------------------ frozen copies
@pytest.mark.parametrize("name", ["fill_sweep_2d", "sweep_2d", "fill_2d",
                                  "fill_2d_swap", "sweep_3d", "fill_3d"])
def test_frozen_min_bytes_matches_the_program(name):
    import torch
    from afivo_streamer_tpu_torch.ops import smoother
    for n in (1, 33, 4096):
        for nc in (2, 8, 16, 32):
            for dtype, item in ((torch.float64, 8), (torch.float32, 4)):
                assert roofline.min_bytes(name, n, nc, item) == \
                    smoother.min_bytes(name, n, nc, dtype)


def test_interior_index_matches_the_program():
    from afivo_streamer_tpu_torch.core import spatial
    for ndim in (2, 3):
        for nc in (8, 16):
            assert np.array_equal(cmp.interior_index(ndim, nc),
                                  spatial.interior_flat(ndim, nc))


# ------------------------------------------------------------ imports
def test_whole_word_import_check():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "afivo_streamer_tpu", "afivo_streamer_tpu.driver",
             "afivo_streamer_tpu_torch", "afivo_streamer_tpu_torch.driver",
             "jaxtyping", "streamer_ref.driver", "numpy"]
    assert isolation.forbidden(names) == [
        "afivo_streamer_tpu", "afivo_streamer_tpu.driver", "flax.linen",
        "jax", "jax.numpy", "jaxlib.xla_client"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.cell, harness.sides, calibrate\n"
        "from harness.sides import Side\n"
        "Side('program'); Side('reference')\n"
        "from harness.isolation import loaded_forbidden\n"
        "print(loaded_forbidden())\n" % (str(BENCH), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import streamer_ref.driver\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'afivo_streamer_tpu_torch', 'afivo_streamer_tpu', 'jax'}))\n"
        % str(BENCH / "reference"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH / "reference", timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ------------------------------------------------------------ no card
def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "cyl_amr_2048", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    from harness.cell import CellRun
    import time
    s = spec()
    cell = small_cell(s, "cyl_amr_2048")
    out = CellRun(s, cell, 3, 1.0, False, time.perf_counter()).run()
    assert out["correct"], out["checks"]


# ------------------------------------------------- the path on the CPU
def test_a_small_cell_through_the_harness_on_the_cpu():
    """The stages of a run (set-up steps, window, reference, comparison)
    on the CPU: the program's plain path equals the frozen reference."""
    import time
    from harness.cell import CellRun
    s = spec()
    cell = small_cell(s, "cyl_amr_2048")
    out = CellRun(s, cell, 2 ** 31 + 9, 0.5, False, time.perf_counter(),
                  device="cpu").run()
    assert out["correct"], out["checks"]
    assert out["warmup_steps"] >= 1 and out["attempted"] >= 1
    assert out["checks"]["state_gap"]["value"] == 0.0
    assert set(out["metrics"]) == {"peak_mem_gb", "setup_s"}
    assert list(out)[-1] == "checks"


def test_a_probe_without_its_calls_stops_the_run(tmp_path):
    """Probes that saw none of their calls in the set-up steps (as where the
    program reshaped the calls they wrap) stop the run, naming each."""
    from harness.probes import Probes
    from harness.sides import Side, cell_argv
    import torch
    cell = small_cell(spec(), "cyl_amr_2048")
    side = Side("program")
    sim = side.simulation(cell_argv(cell, str(tmp_path / "run"), "cpu"), 1)
    probes = Probes(sim, side, torch)
    try:
        with pytest.raises(RuntimeError, match="dt .*vcycles.*epoch"):
            probes.check(4)
    finally:
        probes.remove()
