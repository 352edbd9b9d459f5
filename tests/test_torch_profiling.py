"""The port's spans and counters (`utils/profiling.py`): off without a
profiler, their tree, request ids, counters and host clock under a CPU
torch.profiler, from many threads at once, the self-time arithmetic, the
device-busy union of `device_tables`, the benchmark's traced run reading
them, and on the card a span's stream time against bare CUDA events.

This file imports neither JAX nor the JAX package; the card test carries the
`cuda` marker and skips where no CUDA device is present.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diner_tpu_torch.core import RenderConfig
from diner_tpu_torch.data import BatchLoader, SyntheticSphereDataset, collate
from diner_tpu_torch.models import DINER, PixelNeRF
from diner_tpu_torch.models.diner import to_tensors
from diner_tpu_torch.serve import RenderServer
from diner_tpu_torch.train import create_train_state, train_step
from diner_tpu_torch.utils import profiling
from diner_tpu_torch.utils.profiling import (SpanRecord, count, span,
                                             summarize, take_report)

ROOT = Path(__file__).resolve().parents[1]
H, W, CHUNK, SAMPLES = 24, 32, 200, 6
RENDER_SPANS = {"serve.render", "renderer.rays", "sampler", "field.gather",
                "field.mlp", "composite"}


def _server():
    torch.manual_seed(0)
    model = PixelNeRF(encoder_layers=2, encoder_norm="group",
                      image_padding=4, padding_pe=2, n_blocks=2, d_hidden=32,
                      combine_layer=1, compute_dtype="bfloat16",
                      quad_latent=True, latent_quant="int8")
    cfg = RenderConfig(n_samples=SAMPLES, n_depth_candidates=32,
                       n_gaussian=2, n_prior_anchors=8,
                       paired_prior_gather=True)
    return RenderServer(model, cfg, znear=SyntheticSphereDataset.znear,
                        zfar=SyntheticSphereDataset.zfar, buckets=((H, W),),
                        chunk=CHUNK, device="cpu")


def _scene():
    return collate([SyntheticSphereDataset(n_scenes=1, n_views=2, H=H,
                                           W=W)[0]])


def _load_and_render(server, b, frames):
    server.load_scene("s0", b["src_rgbs"], b["src_depths"],
                      b["src_depth_stds"], b["src_extrinsics"],
                      b["src_intrinsics"])
    for i in range(frames):
        server.render("s0", b["target_extrinsics"], b["target_intrinsics"],
                      H, W, seed=i)


def test_nothing_is_recorded_without_a_profiler():
    take_report()
    assert span("a") is span("b")       # one shared context, no object made
    with span("a"):
        count("c", 3)
    _load_and_render(_server(), _scene(), 1)
    rep = take_report()
    assert rep["spans"] == {} and rep["counters"] == {}
    assert rep["records"] == [] and rep["kernel_launches"] == {}


def test_a_render_records_its_tree_counters_and_host_clock():
    """Two frames and a load under a CPU profiler: each layer's spans under
    their parents, one request id a call, the counters of the chunks, rays
    and samples rendered, and host times within 1 ms of the kineto event of
    the same name."""
    server, b = _server(), _scene()
    take_report()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a profiler's first record_function takes about 1.3 ms past its
        # kineto start to return (one-time set-up, not the clock)
        with torch.profiler.record_function("first"):
            pass
        _load_and_render(server, b, 2)
    rep = take_report()
    recs = rep["records"]
    assert set(rep["spans"]) == RENDER_SPANS | {"serve.load_scene",
                                                "model.encode"}
    by_id = {r.id: r for r in recs}
    parent = {r.id: by_id[r.parent].name if r.parent else None
              for r in recs}
    want = {"serve.render": None, "serve.load_scene": None,
            "model.encode": "serve.load_scene",
            "renderer.rays": "serve.render", "sampler": "renderer.rays",
            "field.gather": "renderer.rays", "field.mlp": "renderer.rays",
            "composite": "renderer.rays"}
    assert all(parent[r.id] == want[r.name] for r in recs)
    roots = [r for r in recs if r.parent is None]
    assert len({r.request for r in roots}) == 3
    for r in recs:
        root = r
        while root.parent:
            root = by_id[root.parent]
        assert r.request == root.request
    n_chunks = -(-H * W // CHUNK)
    padded = n_chunks * CHUNK - H * W
    assert rep["counters"] == {
        "serve.requests": 2, "serve.rays": 2 * H * W,
        "renderer.chunks": 2 * n_chunks, "renderer.padded_rays": 2 * padded,
        "field.samples": 2 * n_chunks * CHUNK * SAMPLES}
    rows = rep["spans"]
    assert rows["renderer.rays"]["calls"] == 2 * n_chunks
    assert rows["serve.render"]["no_parent"] == 2
    assert rows["sampler"]["no_parent"] == 0
    assert all(row["stream_ms"] is None for row in rows.values())
    assert all(0 <= row["host_self_ms"] <= row["host_ms"]
               for row in rows.values())
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in rows]
    for name in rows:
        ev = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == name)
        mine = sorted((r.host_start_ns, r.host_end_ns) for r in recs
                      if r.name == name)
        assert len(ev) == len(mine) == rows[name]["calls"]
        for (es, ee), (s, e) in zip(ev, mine):
            assert abs(es - s) < 1_000_000 and abs(ee - e) < 1_000_000


def test_a_training_step_records_its_parts():
    """One batch from the loader and one train step under a CPU profiler:
    the encoder, the render, the losses, the backward and the optimizer
    under `train.step`, the loader's wait on its own, and the counters."""
    spatch, n_samples = 8, 8
    ds = SyntheticSphereDataset(n_scenes=2, n_views=2, H=32, W=32, seed=0)
    torch.manual_seed(0)
    model = DINER(PixelNeRF(encoder_layers=2, image_padding=4, padding_pe=2,
                            n_blocks=3, d_hidden=32, combine_layer=2),
                  RenderConfig(n_samples=n_samples, n_depth_candidates=64,
                               n_gaussian=3),
                  znear=ds.znear, zfar=ds.zfar, w_vgg=0.1,
                  vgg_spatch=spatch, w_antibias=1.0,
                  antibias_downsampling=2)
    state = create_train_state(model, 1e-3)
    it = iter(BatchLoader(ds, 2, num_threads=1))
    take_report()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = train_step(state, to_tensors(next(it), "cpu"),
                             generator=torch.Generator().manual_seed(0))
    finally:
        it.close()
    rep = take_report()
    assert out["skipped_nonfinite"] == 0.0
    by_id = {r.id: r for r in rep["records"]}
    parent = {r.name: by_id[r.parent].name if r.parent else None
              for r in rep["records"]}
    for name in ("model.encode", "renderer.rays", "train.losses",
                 "train.backward", "train.optimizer"):
        assert parent[name] == "train.step", name
    assert parent["loader.wait"] is None and parent["train.step"] is None
    assert parent["sampler"] == "renderer.rays"
    c = rep["counters"]
    assert c["train.steps"] == 1 and "train.skipped_nonfinite" not in c
    assert c["field.samples"] == 2 * spatch ** 2 * n_samples
    assert c.get("loader.empty_waits", 0) <= 1


def test_spans_and_counters_from_many_threads():
    """16 threads, each 200 parent spans with a child and two counts, under
    a shortened switch interval: no count or span lost, each child under
    its own thread's parent, one request a parent."""
    n_threads, n = 16, 200
    old = sys.getswitchinterval()

    def work():
        for _ in range(n):
            with span("outer"):
                count("hits")
                with span("inner"):
                    count("hits")

    take_report()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rep = take_report()
    assert rep["counters"] == {"hits": 2 * n_threads * n}
    recs = rep["records"]
    by_id = {r.id: r for r in recs}
    outer = [r for r in recs if r.name == "outer"]
    inner = [r for r in recs if r.name == "inner"]
    assert len(outer) == len(inner) == n_threads * n
    assert len({r.request for r in outer}) == n_threads * n
    for r in inner:
        p = by_id[r.parent]
        assert p.name == "outer" and p.thread == r.thread
        assert p.request == r.request


def _rec(i, name, parent, host, stream=None, device=0):
    return SpanRecord(id=i, name=name, parent=parent, request=1, thread=1,
                      host_start_ns=host[0], host_end_ns=host[1],
                      device=device if stream else None,
                      stream_start_ms=stream[0] if stream else None,
                      stream_end_ms=stream[1] if stream else None)


def test_self_time_of_a_hand_built_tree():
    """A's children B and C: apart on the host, overlapping on two streams,
    C past A's end; B's child D; C2 on another device; a second A."""
    recs = [_rec(1, "A", None, (0, 100), (0.0, 10.0)),
            _rec(2, "B", 1, (10, 40), (1.0, 4.0)),
            _rec(3, "C", 1, (50, 70), (3.0, 12.0)),
            _rec(4, "D", 2, (15, 20), (1.5, 2.0)),
            _rec(5, "C2", 1, (60, 65), (0.0, 9.0), device=1),
            _rec(6, "A", None, (200, 210))]
    t = summarize(recs)
    assert t["A"]["calls"] == 2 and t["A"]["no_parent"] == 2
    assert t["A"]["host_ms"] == pytest.approx(110e-6)
    # host: B and C cover 30 + 20 of A's 100 ns (C2 inside C); the second
    # A has no children
    assert t["A"]["host_self_ms"] == pytest.approx((100 - 50 + 10) * 1e-6)
    # stream: B and C cover [1, 10] of A's [0, 10]; C2 is on another device;
    # the second A has no stream times
    assert t["A"]["stream_ms"] == pytest.approx(10.0)
    assert t["A"]["stream_self_ms"] == pytest.approx(1.0)
    assert t["B"]["host_self_ms"] == pytest.approx(25e-6)
    assert t["B"]["stream_self_ms"] == pytest.approx(2.5)
    assert t["C"]["stream_self_ms"] == pytest.approx(9.0)
    assert t["D"]["no_parent"] == 0


class _Event:
    def __init__(self, name, start, end, device, kind):
        self._v = (name, start, end, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self._v[3] == "cpu" else DeviceType.CUDA

    def activity_type(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda self: events})()})()

    def key_averages(self):
        return []


def test_device_busy_is_the_union_of_the_device_intervals():
    """Two kernels on two streams at once count once; the device's mirror
    of a host annotation and an annotation activity count not at all."""
    prof = _Prof([_Event("sampler", 0, 500, "cpu", "cpu_op"),
                  _Event("k1", 100, 300, "cuda", "kernel"),
                  _Event("k2", 200, 400, "cuda", "kernel"),
                  _Event("Memcpy HtoD", 450, 470, "cuda", "gpu_memcpy"),
                  _Event("sampler", 90, 480, "cuda", "gpu_user_annotation"),
                  _Event("mark", 0, 900, "cuda", "gpu_user_annotation")])
    assert profiling.device_intervals(prof) == [(100, 300), (200, 400),
                                                (450, 470)]
    assert profiling.device_tables(prof)[2] == pytest.approx(0.32)


def test_the_benchmark_reads_the_programs_counters():
    """A tiny traced sweep of the benchmark on the CPU: the program counted
    as many requests as the benchmark rendered frames, and the readers of
    the spans' stream times return nothing there."""
    code = (
        "import sys, json\n"
        "sys.path[:0] = ['benchmark', 'benchmark/tests']\n"
        "import run\n"
        "from conftest import TINY_SERVE\n"
        "seen = {}\n"
        "read = run.read_metric\n"
        "def spy(name, ctx):\n"
        "    seen['ctx'] = ctx\n"
        "    return read(name, ctx)\n"
        "run.read_metric = spy\n"
        "r = run.run_cell('diner_dtu.sweep', 2 ** 31 + 77, 1.0, True,\n"
        "                 device='cpu', overrides=TINY_SERVE)\n"
        "from metrics import program_spans\n"
        "rep = program_spans.report(seen['ctx'])\n"
        "print(json.dumps({'metrics': sorted(r['metrics']),\n"
        "                  'frames': seen['ctx']['counts']['frames'],\n"
        "                  'counters': rep['counters'],\n"
        "                  'spans': sorted(rep['spans'])}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["frames"] >= 1
    assert r["counters"]["serve.requests"] == r["frames"]
    assert RENDER_SPANS <= set(r["spans"])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    readers = [m["name"] for m in bench["per_layer"]
               if (ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
                   ).read_text().count("program_spans")]
    assert len(readers) == 9
    assert not set(readers) & set(r["metrics"])
    assert {"serve.load_scene_ms", "render.mfu"} <= set(r["metrics"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stream clock is the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_spans_stream_time_is_the_cuda_events_time(cuda):
    """100 launches of K4 queued behind a sleep (so that the stream never
    waits for the host): a span around them reads, under the profiler,
    within 5% of CUDA events around the same launches without it."""
    from diner_tpu_torch.kernels import composite_rays
    from diner_tpu_torch.kernels.cases import composite_inputs

    rays, z, out = (torch.from_numpy(x).to(cuda)
                    for x in composite_inputs(0, 4, 16384, 32))

    def launches():
        for _ in range(100):
            composite_rays(rays, z, out)

    launches()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    e0.record()
    launches()
    e1.record()
    torch.cuda.synchronize()
    bare = e0.elapsed_time(e1)
    take_report()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(50_000_000)
        with span("k4"):
            launches()
        torch.cuda.synchronize()
    rep = take_report()
    got = rep["spans"]["k4"]["stream_ms"]
    assert rep["kernel_launches"]["composite_rays"] == 100
    assert abs(got - bare) <= 0.05 * bare, (got, bare)
