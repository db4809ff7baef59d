import json

import pytest

from portbench import spans, tracing


def write(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def batch(t0, lost=0.0):
    """One traced batch at ``t0`` (us): the benchmark's spans around the
    program's, launches inside each, their device events later."""
    return [
        ev("user_annotation", "portbench.collate", t0, 20),
        ev("user_annotation", "data.collate", t0 + 1, 18),
        ev("user_annotation", "portbench.to_device", t0 + 20, 10),
        ev("user_annotation", "data.to_device", t0 + 21, 8),
        ev("cuda_runtime", "cudaMemcpyAsync", t0 + 22, 2, corr=t0 + 1),
        ev("gpu_memcpy", "Memcpy HtoD", t0 + 23, 5, tid=9, corr=t0 + 1),
        ev("user_annotation", "portbench.step", t0 + 30, 60),
        ev("user_annotation", "step.eval", t0 + 30, 40),
        ev("user_annotation", "graph.knn", t0 + 31, 10),
        ev("cuda_runtime", "cudaLaunchKernel", t0 + 32, 1, corr=t0 + 2),
        ev("kernel", "knn_kernel<false>", t0 + 40, 30, tid=9, corr=t0 + 2),
        ev("user_annotation", "graph.match", t0 + 45, 10),
        ev("cuda_driver", "cuLaunchKernel", t0 + 46, 1, corr=t0 + 3),
        ev("kernel", "gather", t0 + 70, 4, tid=9, corr=t0 + 3),
        # a launch of step.eval's own, between its children
        ev("cuda_runtime", "cudaGraphLaunch", t0 + 60, 1, corr=t0 + 4),
        ev("kernel", "replayed_a", t0 + 74, 3, tid=9, corr=t0 + 4),
        ev("kernel", "replayed_b", t0 + 77, 3, tid=9, corr=t0 + 4),
        # another thread's launch in graph.knn's time is not graph.knn's
        ev("cuda_runtime", "cudaLaunchKernel", t0 + 35, 1, tid=2,
           corr=t0 + 5),
        ev("kernel", "elsewhere", t0 + 80, 2, tid=9, corr=t0 + 5),
        # a device event whose launch the trace lacks
        ev("kernel", "unknown", t0 + 82, lost, tid=9, corr=t0 + 6),
    ]


def test_device_time_goes_to_the_innermost_span_of_its_launch(tmp_path):
    events = ([ev("user_annotation", "portbench.window", 0, 400)]
              + batch(100) + batch(200))
    sp = spans.read(write(tmp_path, events))
    assert sp.batches() == 2
    inner = {}
    for (stack, name), s in sp.device.items():
        inner[name] = stack
    assert inner["knn_kernel<false>"] == ("window", "step", "step.eval",
                                          "graph.knn")
    assert inner["gather"][-1] == "graph.match"
    assert inner["replayed_a"][-1] == inner["replayed_b"][-1] == "step.eval"
    assert inner["Memcpy HtoD"][-1] == "data.to_device"
    assert inner["elsewhere"] == ()
    assert abs(sp.device_s("graph.knn") - 60e-6) < 1e-12
    assert abs(sp.device_s("step.eval") - 2 * 40e-6) < 1e-12
    assert sp.unattributed_s == 0.0
    r = spans.readings(sp)
    assert abs(r["graph_build_ms"] - 30e-3) < 1e-9
    assert abs(r["graph_match_ms"] - 4e-3) < 1e-9
    assert abs(r["step_dispatch_ms"] - 40e-3) < 1e-9
    assert abs(r["to_device_ms"] - 8e-3) < 1e-9


@pytest.mark.parametrize("lost, readable", [(0.4, True), (0.6, False)])
def test_unattributed_time_past_one_percent_reads_none(tmp_path, lost,
                                                       readable):
    """47 us of attributed device time per batch: 0.4 us unattributed is
    under 1 %, 0.6 us over it."""
    events = ([ev("user_annotation", "portbench.window", 0, 400)]
              + batch(100, lost) + batch(200, lost))
    sp = spans.read(write(tmp_path, events))
    assert abs(sp.unattributed_s - 2 * lost * 1e-6) < 1e-12
    r = spans.readings(sp)
    assert (r["graph_build_ms"] is not None) == readable
    assert (r["graph_match_ms"] is not None) == readable
    assert r["step_dispatch_ms"] is not None     # host times still read


def test_outside_the_window_and_without_spans(tmp_path):
    """Events before the window are not read; a trace without the
    program's spans reads None where it needs them."""
    events = ([ev("user_annotation", "portbench.window", 100, 100)]
              + batch(0) + [
                  ev("user_annotation", "portbench.step", 110, 50),
                  ev("cuda_runtime", "cudaLaunchKernel", 111, 1, corr=1),
                  ev("kernel", "k", 120, 10, tid=9, corr=1)])
    sp = spans.read(write(tmp_path, events))
    assert sp.batches() == 0 and sp.host_ms("data.collate") is None
    assert set(spans.readings(sp).values()) == {None}
    assert abs(sp.device_s("step") - 10e-6) < 1e-12


def test_idle_gaps_are_named_by_the_innermost_span(tmp_path):
    events = ([ev("user_annotation", "portbench.window", 0, 400)]
              + batch(100))
    path = write(tmp_path, events)
    sp = spans.read(path)
    tl = tracing.read_trace(path)
    gaps = {k: v for k, v in sp.idle_by_span(tl.gaps()) if v > 1e-12}
    # busy 123-128 and 140-182 us: the gap at 128-140 is graph.knn's, not
    # the benchmark's step around it
    assert set(gaps) == {"graph.knn", "host: other"}
    assert abs(gaps["graph.knn"] - 12e-6) < 1e-12
    assert abs(gaps["host: other"] - (123e-6 + 218e-6)) < 1e-12
    assert abs(dict(tl.idle_by_host())["step"] - gaps["graph.knn"]) < 1e-12


@pytest.mark.card
def test_knn_launches_fall_under_graph_knn_on_the_card(tmp_path):
    """One DRN evaluation step on the card under ``profiling.trace``:
    every ``knn_kernel`` of the fused graph build is attributed to
    ``graph.knn``, and nothing of the step is unattributed."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepmetv2_tpu_torch.config import Config, DRNConfig
    from deepmetv2_tpu_torch.data import collate, to_device
    from deepmetv2_tpu_torch.data.synthetic import synthetic_events
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.train.step import make_drn_eval_step
    from deepmetv2_tpu_torch.utils import profiling

    cfg = Config(drn=DRNConfig(head="cartesian"))
    model = DRN(cfg.drn, device="cuda")
    step = make_drn_eval_step(cfg)
    host = collate(synthetic_events(4, seed=3, n_min=300, n_max=500),
                   buckets=(512,))
    step(model, to_device(host, "cuda"))          # builds the kernels
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path / "tr")):
        step(model, to_device(host, "cuda"))
        torch.cuda.synchronize()
    sp = spans.read(str(tmp_path / "tr" / "trace.json"))
    knn = {stack: s for (stack, name), s in sp.device.items()
           if "knn_kernel" in name}
    assert knn and all("graph.knn" in stack for stack in knn)
    assert sp.unattributed_share() == 0.0 and sp.batches() == 1
    assert sp.device_s("graph.knn") >= sum(knn.values()) > 0
    assert sp.device_s("graph.match") > 0
