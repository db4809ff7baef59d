"""Entries, families and kernel declarations are found by file: a new
model family arrives as new files only, and the port's config sections and
kernel declarations reach the harness with no edit of it."""

import dataclasses
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import cell, spec
from portbench.faults import patched
from portbench.tests.tiny import run_tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = sorted((spec.HERE / "configs").glob("*.json"))

# counts/kernels.json as it stood when each kernel module got a file of its
# own under counts/kernels/
TODAY = {
    "port": "window_max_|knn_|edge_mlp_|ordered_sum_kernel|"
            "rev_(hist|chunk_scan|offsets|fill)_kernel",
    "per_wrapper": {
        "window_max": "window_max_fwd_kernel",
        "window_max_bf16": "window_max_fwd_kernel",
        "window_max_bwd": "window_max_bwd_kernel",
        "window_max_bwd_bf16": "window_max_bwd_kernel",
        "knn_kth": "knn_kernel<false>",
        "knn_extract": "knn_kernel<true>",
        "edge_mlp_fwd": "edge_mlp_fwd_kernel",
        "edge_mlp_bwd": "edge_mlp_bwd_kernel",
    },
}

STUB_FAMILY = '''"""A family with no model: MET is minus the sum of the candidates'
transverse momenta, its reference the same sum in float64 on the host."""

import numpy as np
import torch

from portbench import cell


class Serve:
    def __init__(self, r, events):
        self.r = r

    def step(self, batch, keep):
        m = batch.mask.to(batch.x_cont.dtype)
        met = -torch.stack([(batch.x_cont[..., 0] * m).sum(-1),
                            (batch.x_cont[..., 1] * m).sum(-1)], -1)
        return met.cpu().numpy(), None, None

    def release(self):
        pass

    def check(self, kept):
        port = np.concatenate([met[:len(evs)] for evs, met, _, _ in kept])
        want = np.stack([-x[:, :2].astype(np.float64).sum(0)
                         for evs, _, _, _ in kept for x, _ in evs])
        return {"met_rel": cell.met_rel(port, want)}

    def counts(self, batches, widths):
        return 0.0, 0.0
'''


@pytest.mark.parametrize("cell_name", CELLS)
def test_every_cell_resolves_its_entry_and_family_by_file(cell_name):
    s = spec.cell_spec(cell_name)
    entry = spec.entry(s.traffic["entry"])
    assert callable(entry.run)
    assert isinstance(spec.family(s.config["family"], entry.ROLE), type)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_configuration_names_a_family_file(path):
    name = spec.load_json(path)["family"]
    mod = spec.named("families", name)
    assert any(isinstance(getattr(mod, role, None), type)
               for role in ("Train", "Serve"))


def test_unknown_entry_or_family_stops_with_the_names_there_are():
    with pytest.raises(SystemExit, match=r"no entries/serve\.py: .*"
                                         r"\['infer', 'train'\]"):
        spec.entry("serve")
    with pytest.raises(SystemExit, match=r"no families/particlenet\.py: "
                                         r".*\['drn', 'graphmet'\]"):
        spec.family("particlenet", "Train")


def stub_checkout(tmp_path: Path) -> Path:
    """A copy of the checkout's benchmark with one family added as new
    files: ``families/stub.py``, its configuration, traffic and limits,
    and a ``configs`` and a ``workloads`` entry."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "portbench"
    (here / "families" / "stub.py").write_text(STUB_FAMILY)
    (here / "configs" / "stub.json").write_text(json.dumps(
        {"family": "stub", "source": "none", "reduced": [],
         "data": {"node_buckets": [128, 256]}}))
    traffic = spec.load_json(here / "traffic" / "graphmet-infer-cms.json")
    traffic.update(events=8, batch=4, sample_batches=2, sample_from=2)
    (here / "traffic" / "stub-infer.json").write_text(json.dumps(traffic))
    (here / "limits" / "stub-infer.json").write_text(
        json.dumps({"met_rel": 1e-4}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "stub", "source": "none",
                             "file": "portbench/configs/stub.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "stub-infer", "config": "stub",
                               "traffic": "stub-infer", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def files(top: Path) -> dict:
    return {p.relative_to(top): p.read_bytes() for p in top.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_runs_as_new_files_only(tmp_path):
    root = stub_checkout(tmp_path)
    here = root / "portbench"
    before = files(spec.HERE)
    with patched(spec, "ROOT", root), patched(spec, "HERE", here):
        outcome, result = run_tiny("stub-infer")
        with pytest.raises(SystemExit, match=r"family 'stub' \(families/"
                                             r"stub\.py\) has no Train.*"
                                             r"\['Serve'\]"):
            spec.family("stub", "Train")
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"met_rel"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    copied = files(here)
    added = {Path(p) for p in ("families/stub.py", "configs/stub.json",
                               "traffic/stub-infer.json",
                               "limits/stub-infer.json")}
    assert set(copied) - set(before) == added
    assert all(copied[p] == before[p] for p in before)


def test_stub_family_check_sees_a_wrong_answer(tmp_path):
    """The stub's own check is a real one: its MET off by 1 % in one
    event reads over its limit."""
    root = stub_checkout(tmp_path)
    here = root / "portbench"
    fam = here / "families" / "stub.py"
    fam.write_text(fam.read_text().replace(
        "return met.cpu().numpy(), None, None",
        "met[0] *= 1.01\n        return met.cpu().numpy(), None, None"))
    with patched(spec, "ROOT", root), patched(spec, "HERE", here):
        outcome, result = run_tiny("stub-infer")
    assert not result["correct"], result["checks"]


def test_todays_kernel_declarations_merge_to_todays_patterns():
    decl = [spec.load_json(spec.HERE / "counts" / "kernels" / f"{m}.json")
            for m in ("window_max", "knn_und", "edge_mlp")]
    merged = cell.merge_kernels(decl)
    assert merged["port"] == TODAY["port"]
    assert merged["per_wrapper"] == TODAY["per_wrapper"]


# kernel names of the port's sources, and one outside the declarations
NAMES = ["window_max_fwd_kernel", "window_max_bwd_kernel", "knn_kernel<false>",
         "knn_kernel<true>", "knn_sqnorm_kernel", "knn_compact_kernel",
         "edge_mlp_proj_kernel", "edge_mlp_fwd_kernel", "edge_mlp_bwd_kernel",
         "ordered_sum_kernel", "rev_hist_kernel", "rev_chunk_scan_kernel",
         "rev_offsets_kernel", "rev_fill_kernel", "cat_embed_fwd_kernel",
         "void at::native::vectorized_elementwise_kernel"]


def test_kernel_patterns_merge_every_declaration():
    files = sorted((spec.HERE / "counts" / "kernels").glob("*.json"))
    assert files
    pats = cell.kernel_patterns()
    assert pats == cell.merge_kernels([spec.load_json(p) for p in files])
    for name in NAMES:
        assert (bool(re.search(pats["port"], name))
                == bool(re.search(TODAY["port"], name))), name
    for wrapper, pattern in TODAY["per_wrapper"].items():
        assert pats["per_wrapper"][wrapper] == pattern
    with pytest.raises(ValueError, match="knn_kth"):
        cell.merge_kernels([{"port": "a", "per_wrapper": {"knn_kth": "a"}},
                            {"port": "b", "per_wrapper": {"knn_kth": "b"}}])


def test_port_config_passes_a_section_the_config_gains():
    """A section the port's ``Config`` gains, and registers in its loader
    ``from_json`` as its CLIs need, reaches the port with no edit here."""
    from deepmetv2_tpu_torch import config as port_config

    Base = port_config.Config

    @dataclasses.dataclass(frozen=True)
    class Extra:
        width: int = 1
        sizes: tuple = ()

    @dataclasses.dataclass(frozen=True)
    class Wider(Base):
        extra: Extra = dataclasses.field(default_factory=Extra)

        @staticmethod
        def from_json(s: str) -> "Wider":
            raw = json.loads(s)
            base = Base.from_json(s)
            extra = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in raw.get("extra", {}).items()}
            return Wider(**{f.name: getattr(base, f.name) for f in
                            dataclasses.fields(Base)},
                         extra=Extra(**extra))

    cfgj = spec.load_json(CONFIGS[0])
    cfgj["extra"] = {"width": 7, "sizes": [1, 2]}
    with patched(port_config, "Config", Wider):
        cfg = cell.port_config(cfgj, extra={"width": 9},
                               data={"batch_size": 3})
    assert isinstance(cfg, Wider)
    assert cfg.extra == Extra(9, (1, 2))
    assert cfg.data.batch_size == 3
    assert cfg.data.node_buckets == tuple(cfgj["data"]["node_buckets"])
    assert cfgj["extra"] == {"width": 7, "sizes": [1, 2]}   # left as it was


def test_port_config_builds_what_from_json_builds():
    from deepmetv2_tpu_torch.config import Config

    for path in CONFIGS:
        cfgj = spec.load_json(path)
        raw = {k: v for k, v in cfgj.items()
               if k in {f.name for f in dataclasses.fields(Config)}}
        assert cell.port_config(cfgj) == Config.from_json(json.dumps(raw))
