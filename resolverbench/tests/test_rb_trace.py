"""The trace reduction: the union of device intervals, launch and sync
counting (held against chip_smoke.py's counting), the program's kernel
names, and a synthetic trace summarised."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
import foundationdb_tpu_torch
from resolverbench import trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_counts_each_busy_instant_once(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 500, 60)
    iv = np.stack([a, a + rng.integers(0, 40, 60)], axis=1).astype(float)
    busy = np.zeros(600, dtype=bool)
    for s, e in iv.astype(int):
        busy[s:e] = True
    merged = trace.union(iv)
    assert (merged[1:, 0] > merged[:-1, 1]).all()
    assert (merged[:, 1] - merged[:, 0]).sum() == busy.sum()
    gaps = trace.gaps(trace.union(trace.clip(iv, 100, 400)), 100, 400)
    assert (gaps[:, 1] - gaps[:, 0]).sum() == (~busy[100:400]).sum()


def test_launch_and_sync_counting_agree_with_chip_smoke():
    names = (["cudaLaunchKernel"] * 7 + ["cudaLaunchCooperativeKernel"] * 2 +
             ["cudaStreamSynchronize"] * 3 + ["cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "cudaLaunchHostFunc", "aten::add"])
    averaged = [SimpleNamespace(key=n, count=names.count(n)) for n in set(names)]
    assert sum(map(trace.is_launch, names)) == chip_smoke.launch_calls(averaged)
    assert sum(map(trace.is_sync, names)) == chip_smoke.sync_calls(averaged)
    # the cluster launches of K2 and K5 go through cudaLaunchKernelEx,
    # which chip_smoke's list leaves out
    assert trace.is_launch("cudaLaunchKernelExC") and trace.is_launch("cudaLaunchKernelExC_v11060")
    assert not chip_smoke.launch_calls([SimpleNamespace(key="cudaLaunchKernelExC", count=1)])


def test_hand_symbols_are_the_programs_kernels():
    found = trace.hand_symbols(Path(foundationdb_tpu_torch.__file__).parent)
    named = {symbol for _n, _w, symbol in chip_smoke.KERNELS}
    named |= set(chip_smoke.WIDE_SYMBOLS.values()) | {chip_smoke.CLUSTER_SYMBOL}
    assert named <= set(found)


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_summarize_a_synthetic_trace():
    ev = [
        _x("user_annotation", "rb.generate", 0, 100),
        _x("user_annotation", "rb.dispatch", 100, 300),
        _x("gpu_user_annotation", "rb.dispatch", 100, 300),  # not device work
        _x("cpu_op", "aten::cummax", 120, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 130, 5),
        _x("cuda_runtime", "cudaLaunchKernelExC", 150, 5),
        _x("cpu_op", "aten::item", 200, 150),
        _x("cuda_runtime", "cudaStreamSynchronize", 210, 130),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 105, 10),
        _x("kernel", "void at::native::tensor_kernel_scan<long>", 140, 100, tid=7),
        _x("kernel", "probe_fused_kernel(int const*, int)", 200, 20, tid=8),
        _x("kernel", "void intra_cluster_kernel<8>(int*)", 230, 20, tid=7),
        _x("kernel", "probe_fused_warp_kernel_x(int)", 300, 10, tid=7),
        _x("user_annotation", "rb.read", 400, 100),
    ]
    s = trace.summarize(ev, ["probe_fused_kernel", "intra_cluster_kernel"])
    assert s["window_s"] == pytest.approx(500e-6)
    # [105, 115) + [140, 250) + [300, 310): the two kernels overlapping
    # [200, 220) count once
    assert s["busy_s"] == pytest.approx(130e-6)
    assert (s["launches"], s["syncs"]) == (2, 1)
    assert s["h2d_s"] == pytest.approx(10e-6)
    assert s["hand_s"] == pytest.approx(40e-6)
    assert s["torch_s"] == pytest.approx(110e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["rb.read"] == pytest.approx(100e-6)
    assert gaps["rb.dispatch: cudaStreamSynchronize"] == pytest.approx(80e-6)
    assert gaps["rb.dispatch: aten::cummax"] == pytest.approx(15e-6)
    assert gaps["rb.generate"] == pytest.approx(100e-6)
    assert sum(gaps.values()) == pytest.approx(500e-6 - s["busy_s"])
    assert s["device_ops"][0] == ["void at::native::tensor_kernel_scan<long>",
                                  pytest.approx(100e-6)]


def test_summarize_finds_nothing_without_device_events():
    assert trace.summarize([_x("user_annotation", "rb.read", 0, 10)], []) is None
