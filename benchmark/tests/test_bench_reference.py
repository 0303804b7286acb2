"""The plain reference against the port at a small size on the CPU, and a
lower precision in the program's place failing the same comparison."""

import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmark.reference
from benchmark.harness import data, main, program, spec
from benchmark.reference import mimamo as reference

from .conftest import tiny, tiny_config

REF_DIR = Path(reference.__file__).resolve().parent


def test_reference_imports_nothing_of_the_program():
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("mimamo_tpu_torch", "jax",
                                               "mimamo_tpu", "flax"), path


CONFIGS = {c["name"]: c["file"] for c in spec.benchmark_file()["configs"]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schema_is_the_ports_state_dict(name):
    """Each configuration's reference, found by its file, gives the
    port's ``state_dict``: the same names and shapes."""
    config = tiny_config(json.loads((spec.ROOT / CONFIGS[name]).read_text()))
    schema = benchmark.reference.for_config(config).schema(config)
    model = program.build_model(config, data.make_weights(config, 3, "cpu"),
                                "cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: s for n, s, _, _ in schema} == want


def test_every_reference_defines_the_interface():
    for name in benchmark.reference.names():
        module = benchmark.reference.for_config({"reference": name})
        for attr in ("schema", "check_supported", "Reference",
                     "train_steps", "FAULTS"):
            assert hasattr(module, attr), (name, attr)
    assert benchmark.reference.for_config({}) is reference


@pytest.mark.parametrize("name", ["nosuch", "mimamo.nosuch", "", 3])
def test_an_unknown_reference_is_refused(name):
    with pytest.raises(KeyError, match="references: .*'mimamo'"):
        benchmark.reference.for_config({"reference": name})


@pytest.mark.parametrize("section,key", [("backbone", "se_reduction"),
                                         ("temporal", "attention_heads"),
                                         ("train", "label_smoothing")])
def test_a_key_the_reference_does_not_compute_is_refused(section, key):
    """A configuration with a key that ``mimamo`` does not know is another
    model: refused, before set-up and when the reference is built, with a
    message that names the key."""
    cell = spec.load_cell("bf16-clips")
    config, mix = tiny(cell)
    config[section][key] = 16
    match = f"{section}: .*'{key}'.*reference of the configuration's own"
    with pytest.raises(ValueError, match=match):
        reference.check_supported(config)
    with pytest.raises(ValueError, match=match):
        main.execute(cell, 1, 0.1, False, "cpu", time.perf_counter(),
                     config=config, mix=mix)
    with pytest.raises(ValueError, match=match):
        reference.Reference(config, {}, "cpu")


def test_a_leaf_kind_make_weights_does_not_draw_is_refused(monkeypatch):
    schema = reference.schema

    def with_gate(cfg):
        return schema(cfg) + [("backbone.layer1.0.se.fc1.weight",
                               (16, 256, 1, 1), "se_gate", 256)]
    monkeypatch.setattr(reference, "schema", with_gate)
    config, _ = tiny(spec.load_cell("bf16-clips"))
    with pytest.raises(ValueError,
                       match="'backbone.layer1.0.se.fc1.weight'.*'se_gate'"):
        data.make_weights(config, 1, "cpu")


def test_fp32_port_matches_the_reference():
    """At fp32 the port and the reference agree to round-off over clips,
    and a stream fed chunk by chunk."""
    cell = spec.load_cell("fp32-train")
    config, _ = tiny(cell)
    state = data.make_weights(config, 5, "cpu")
    model = program.build_model(config, state, "cpu")
    ref = reference.Reference(config, state, "cpu")
    clips = data.make_clips(5, "cpu", 1, 2, 6, 32)[0]
    got = model.predict_clips(clips).numpy()
    want = ref.clips(clips).numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    seq = clips[0]
    carries, outs = None, []
    for i in range(0, 6, 3):
        out, carries = model.predict_stream(seq[None, i:i + 3], carries)
        outs.append(out[0])
    streamed = torch.cat(outs).numpy()
    assert np.abs(streamed - want[0]).max() < 1e-4 * np.abs(want).max()


def test_training_reference_matches_the_port():
    cell = spec.load_cell("fp32-train")
    config, mix = tiny(cell)
    result = main.execute(cell, 11, 0.2, False, "cpu", time.perf_counter(),
                          config=config, mix=mix)
    for name, c in result["checks"].items():
        assert c["value"] < 1e-3, (name, c)


@pytest.mark.parametrize("name", ["bf16-clips", "bf16-streams"])
def test_fp8_control_fails_the_cells_comparison(name):
    """The reference in fp8 put in the program's place reads above the
    cell's limit; the bf16 program at the same size reads under it."""
    from benchmark.tools.readings import readings
    cell = spec.load_cell(name)
    config, mix = tiny(cell)
    out = readings(cell, 21, 0.2, ["fp8"], "cpu", config=config, mix=mix)
    limit = cell.limits["out_err"]
    assert out["program"]["out_err"] < limit < out["fp8"]["out_err"]


@pytest.mark.card
def test_tf32_control_fails_the_train_cell(card):
    """On the card, at the cell's own size: TF32 in the program's place
    fails the training cell's comparison."""
    from benchmark.tools.readings import readings
    cell = spec.load_cell("fp32-train")
    out = readings(cell, 31, 1.0, ["tf32"], "cuda")
    assert any(v > cell.limits[k] for k, v in out["tf32"].items())
    assert all(v <= cell.limits[k] for k, v in out["program"].items())


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    q = reference.fp8(x)
    rel = ((q - x).abs() / x.abs().clamp_min(1e-3))[x.abs() > 0.1]
    assert 0.01 < float(rel.max()) <= 0.0625 + 1e-6
