"""Where a training call spends its time, on the card.

    python -m mocogan_tpu_torch.utils.profiling --config mug [--host-fed]
        [--out DIR] [--set K=V ...]

``--set`` takes the train CLI's dotted overrides, e.g. ``--set
model.compute_dtype=bfloat16 train.batch_size=32``.

Renders the synthetic 96 px clip store, builds the state at the config's
full width, warms up with one call of k = train.steps_per_call steps, times
one call, then traces one call with ``torch.profiler`` and prints one JSON
line:
  * the call's wall time and steps/s (host clock, ends in a host read of
    the metrics);
  * the device's busy time (the union of its kernel, copy and set
    intervals in the trace) and its idle share of the call;
  * device time per phase of the step (the ``record_function`` ranges of
    ``train/step.py``: plan, ingest, losses, grads, adam);
  * the kernels that took the most device time.
By default a call is the device-cached one (``cached_multi_train_step``
on the resident store). With --host-fed it is the host-fed trainer's
(``data.pipeline.HostFeed``): k batches assembled by the native clip store
and stacked in pinned memory on the prefetch thread, the stack's upload
started on a copy stream after the call is queued, and
``multi_train_step`` on the uploaded stack; the line then also holds the
seconds the call waited for the prefetch thread. With --out it writes the
Chrome trace there. fp32 runs in full fp32 (TF32 off for matmuls and
cuDNN).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

PHASES = ("plan", "ingest", "losses", "grads", "adam")


def profile_call(cfg, device, out_dir=None, top: int = 15,
                 host_fed: bool = False) -> dict:
    from mocogan_tpu_torch.data import clips, synthetic
    from mocogan_tpu_torch.data.pipeline import HostFeed
    from mocogan_tpu_torch.ops import preproc
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.train import step as train_step

    k = cfg.train.steps_per_call
    torch.cuda.reset_peak_memory_stats(device)
    state = train_state.create(cfg, device=device)
    feed = None
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.write_store(tmp, clips=96,
                              frames=max(32, cfg.model.video_length),
                              size=cfg.data.raw_size,
                              classes=cfg.model.n_classes)
        if host_fed:
            feed = HostFeed(clips.clip_batch_iterator(
                dataclasses.replace(cfg, data=dataclasses.replace(
                    cfg.data, data_dir=tmp)), use_native=True),
                k, device, depth=cfg.data.prefetch)
            current = feed.next()

            def run():
                nonlocal current
                m = train_step.multi_train_step(state, *current)
                current = feed.next()
                return m
        else:
            pool_np, lengths_np, labels_np = clips.load_pool(tmp)
            pool = torch.from_numpy(pool_np).to(device)
            lengths = torch.from_numpy(lengths_np)
            labels = torch.from_numpy(labels_np)
            rh, rw = preproc.resize_weights(pool.shape[2], pool.shape[3],
                                            cfg.model.image_size, device)

            def run():
                return train_step.cached_multi_train_step(
                    state, pool, lengths, k, rh, rw, labels=labels)

        def call():
            return {key: float(v) for key, v in run().items()}

        try:
            return _profile(call, k, device, out_dir, top, feed)
        finally:
            if feed is not None:
                feed.close()


def _profile(call, k, device, out_dir, top, feed) -> dict:
    from torch.profiler import ProfilerActivity, profile

    call()                                         # warm-up
    torch.cuda.synchronize()
    wait0 = feed.wait_s if feed is not None else 0.0
    t0 = time.perf_counter()
    call()
    plain_s = time.perf_counter() - t0
    wait_s = feed.wait_s - wait0 if feed is not None else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        traced_s = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(out_dir or tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    kernels = [e for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                      # union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    window_us = spans[-1][1] - spans[0][0]
    per_kernel: dict = {}
    for e in kernels:
        n = e["name"][:90]
        t, c = per_kernel.get(n, (0.0, 0))
        per_kernel[n] = (t + float(e["dur"]), c + 1)
    # device time of the kernels launched inside each range
    phases = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
              if e.key in PHASES}
    top_k = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device": torch.cuda.get_device_name(device),
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "host_fed": feed is not None, "prefetch_wait_s": wait_s,
        "k": k, "call_s": plain_s, "steps_per_s": k / plain_s,
        "traced_call_s": traced_s,
        "device_busy_ms": busy_us / 1e3,
        "device_window_ms": window_us / 1e3,
        "device_idle_share_traced": 1.0 - busy_us / 1e6 / traced_s,
        # the same device work against the untraced call's wall time
        "device_idle_share": 1.0 - busy_us / 1e6 / plain_s,
        "kernels_per_step": len(kernels) / k,
        "phase_device_ms": phases,
        "top_kernels_ms": [[n, t / 1e3, c] for n, (t, c) in top_k],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="mug")
    ap.add_argument("--out", default=None, help="write trace.json here")
    ap.add_argument("--host-fed", action="store_true",
                    help="profile the host-fed trainer's call")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides",
                    help="dotted config overrides, as the train CLI takes")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.train.__main__ import parse_overrides
    from mocogan_tpu_torch.utils.platform import resolve_device

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.config, **parse_overrides(args.overrides))
    out = profile_call(cfg, device, args.out, host_fed=args.host_fed)
    print(json.dumps({"config": cfg.name,
                      "overrides": args.overrides or [], **out}))


if __name__ == "__main__":
    main()
