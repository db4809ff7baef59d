import json

from portbench import tracing


def write(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_a_union_and_gaps_are_named(tmp_path):
    tl = tracing.read_trace(write(tmp_path, [
        ev("user_annotation", "portbench.window", 0, 100),
        ev("user_annotation", "portbench.collate", 0, 20),
        ev("user_annotation", "portbench.step", 20, 80),
        ev("kernel", "void knn_kernel<false>(float)", 30, 30),
        ev("kernel", "gemm", 40, 30),            # overlaps the first
        ev("gpu_memcpy", "Memcpy HtoD", 80, 10),
        ev("cpu_op", "aten::add", 0, 100),
    ]))
    assert abs(tl.busy_s() - 50e-6) < 1e-12
    gaps = dict(tl.idle_by_host())
    assert abs(gaps["collate"] - 30e-6) < 1e-12    # by its middle
    assert abs(gaps["step"] - 20e-6) < 1e-12
    seconds, launches = tl.matching("knn_kernel<false>")
    assert abs(seconds - 30e-6) < 1e-12 and launches == 1
    ok, seen = tracing.coverage(tl, {"knn_kth": 1, "knn_extract": 0},
                                {"knn_kth": "knn_kernel<false>"})
    assert ok and seen == {"knn_kth": [1, 1]}
    assert not tracing.coverage(tl, {"knn_kth": 2},
                                {"knn_kth": "knn_kernel<false>"})[0]
