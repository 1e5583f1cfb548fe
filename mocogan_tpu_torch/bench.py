"""The port's benchmark: training steps/s of the flagship 64x64x16f mug
model on one GPU, with generated clips/s, the batch frontier, the bf16
recipe, ``scaled``, the ingest kernel's check and card-against-CPU parity.

    python -m mocogan_tpu_torch.bench [--device cpu]

Prints ONE JSON line last:
  {"metric": "train_steps_per_sec_64x64x16f", "value": N, "unit":
   "steps/sec", "vs_baseline": N, "extra": {...}}

``value`` is the best window of the fp32 single step (TF32 off);
``vs_baseline`` is its speedup over the same step on this machine's CPU
(the ``cpu_oracle`` stage, cached in ``.bench_torch_cpu_baseline.json``).

Architecture, that of the JAX package's ``bench.py``:
  * the parent process never touches the card: it calls nothing under
    ``torch.cuda`` (a wedged card can hang even in ``is_available``) and
    runs every stage in a child process, ``python -m
    mocogan_tpu_torch.bench --stage NAME --stage-args JSON``, in its own
    session, and kills the child's whole process group at the stage's
    timeout (a stage may start a grandchild: ``parity`` reruns on the CPU);
  * a preflight stage (a 256x256 matmul and a synchronize) gates every
    stage on the card, and reads the card's name and power limit;
  * an overall budget (BENCH_BUDGET_SEC, default 1200) caps each stage's
    timeout and skips the stages it cannot fit;
  * after two timeouts in a row the preflight runs again; if it fails the
    remaining stages are skipped (``gpu_died_mid_run``);
  * the line is always printed, with each stage's result under
    ``extra.results`` and its diagnostics under ``extra.stages``.

The exit code is 1 when a stage that ran timed out or failed (a kernel or
parity check raises in its stage), or the preflight found no card; 0 only
when every stage that ran was ok. A stage skipped for budget is listed and
does not change it. Without a GPU there is no fallback: ``--device cpu``
is for the CPU tests.

Every timed stage sets both TF32 switches (``matmul.allow_tf32``,
``cudnn.allow_tf32``) in its child and records them; no stage sets
``cudnn.deterministic``, ``cudnn.benchmark`` or deterministic algorithms.
Each result carries the stage's ingest-kernel launches
(``ops/preproc.LAUNCHES``) and, on the card, its peak
``max_memory_allocated``.

Environment: BENCH_BF16 / BENCH_SCAN / BENCH_BATCHES / BENCH_GENERATE /
BENCH_SCALED / BENCH_PARITY (=0 skips those stages), BENCH_BUDGET_SEC,
BENCH_STEPS / BENCH_WARMUP (single-step windows), BENCH_STAGE_TIMEOUTS
(JSON {stage: seconds}), BENCH_CPU_CACHE (the oracle's cache file), and
the test hooks BENCH_OVERRIDES (JSON config overrides, a small geometry),
BENCH_FAKE_HANG (stage names whose child sleeps before it imports torch)
and BENCH_FAKE_FAIL_AFTER ("stage:N:counterfile": that stage's child
exits 3 after N runs).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# seconds; each is also capped by the budget left. A stage costs a torch
# import and a CUDA context (~10 s), the first cuDNN plans and its windows.
STAGE_TIMEOUTS = {
    "preflight": 120.0,
    "cpu_oracle": 900.0,
    "kernel_verify": 240.0,
    "train": 540.0,
    "scan": 540.0,
    "scaled": 540.0,
    "generate": 600.0,
    "parity": 420.0,
}
MARKER = "BENCHSTAGE:"
KERNEL_TOL = 1e-5       # the kernel's values lie in [-1, 1]
PARITY_TOL = 1e-4       # generate() card vs CPU, fp32 (chip_smoke.py's)
PARITY_N, PARITY_SEED = 2, 0    # the golden recipe's clips and init seed
TF32_MODES = ("off", "default")


def _steps() -> int:
    return int(os.environ.get("BENCH_STEPS", "50"))


def _warmup() -> int:
    return int(os.environ.get("BENCH_WARMUP", "6"))


def _overrides() -> dict:
    """BENCH_OVERRIDES: config overrides of the tests' small geometry. A
    value that is not a JSON object raises: it must not read as full
    width."""
    ov = json.loads(os.environ.get("BENCH_OVERRIDES") or "{}")
    if not isinstance(ov, dict):
        raise ValueError(f"BENCH_OVERRIDES must be a JSON object, got {ov!r}")
    return ov


def _cache_path() -> str:
    return os.environ.get("BENCH_CPU_CACHE", os.path.join(
        REPO, ".bench_torch_cpu_baseline.json"))


# --------------------------------------------------------------------------
# Stages: each runs in its own child process, which prints MARKER and one
# JSON object as its last line of output.
# --------------------------------------------------------------------------

def _cfg(dtype: str = "float32", batch_size=None, overrides=None,
         name: str = "mug"):
    from mocogan_tpu_torch import get_config

    ov = {"model.compute_dtype": dtype} if name == "mug" else {}
    if batch_size:
        ov["train.batch_size"] = batch_size
    if name == "scaled":
        ov["train.num_devices"] = 1
    return get_config(name, **{**ov, **(overrides or {}), **_overrides()})


def set_tf32(mode: str) -> dict:
    """Set both TF32 switches: "off" turns both off (full fp32); "default"
    leaves them as a fresh process has them (as the train CLI does:
    cuDNN may use TF32, matmuls do not). Returns the two settings."""
    import torch

    if mode not in TF32_MODES:
        raise ValueError(f"tf32 must be one of {TF32_MODES}, got {mode!r}")
    if mode == "off":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return {"mode": mode,
            "matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}


def device_info(dev) -> dict:
    """The device, torch's and CUDA's versions and, on a GPU, the card's
    name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (null on the CPU)."""
    import torch

    info = {"device": str(dev), "torch": torch.__version__,
            "cuda": torch.version.cuda, "smi": None, "name": None,
            "power_limit": None}
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        name, _, power = smi.rpartition(",")
        info.update(smi=smi, name=name.strip(), power_limit=power.strip())
    return info


def stage_preflight(args, dev):
    """A 256x256 matmul and one synchronize: the cheapest full round trip
    to the card; a wedged card hangs here, in a child the parent kills."""
    import torch

    t0 = time.time()
    x = torch.ones((256, 256), dtype=torch.float32, device=dev)
    y = x @ x
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if float(y[0, 0]) != 256.0:
        raise AssertionError(f"preflight matmul gave {float(y[0, 0])}")
    return {"ok": True, **device_info(dev),
            "seconds": round(time.time() - t0, 3)}


def stage_cpu_oracle(args, dev):
    """The mug b16 fp32 train step on this machine's CPU, never the card:
    one warm-up step, then 3 timed. Cached per geometry, so a
    test's small geometry never stands in for the full-width anchor."""
    import torch

    from mocogan_tpu_torch.data import synthetic
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.train import step as train_step
    from mocogan_tpu_torch.utils import benchmarking

    key = "mug_b16"
    ov = os.environ.get("BENCH_OVERRIDES", "")
    if ov and ov != "{}":
        key += "_ov" + hashlib.sha1(ov.encode()).hexdigest()[:8]
    path = _cache_path()
    cached = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                cached = json.load(f)
        except ValueError:
            cached = {}
        if key in cached:
            return {"steps_per_sec": float(cached[key]), "cached": True,
                    "key": key}
    cfg = _cfg(batch_size=16)
    m = cfg.model
    s = train_state.create(cfg, device="cpu")
    vids, _ = synthetic.make_batch(0, cfg.train.batch_size,
                                   t=m.video_length, size=m.image_size,
                                   channels=m.channels)
    v = torch.from_numpy(vids)
    benchmarking._read(train_step.train_step(s, v))
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        metrics = train_step.train_step(s, v)
    benchmarking._read(metrics)
    sps = n / (time.perf_counter() - t0)
    cached[key] = sps
    with open(path, "w") as f:
        json.dump(cached, f)
    return {"steps_per_sec": sps, "cached": False, "key": key,
            "threads": torch.get_num_threads()}


def _kernel_layouts():
    """(name, pool, out size) of the check: the mug layout and scaled's."""
    import numpy as np

    rng = np.random.default_rng(0)
    return (("mug", rng.integers(0, 256, (4, 16, 96, 96, 3), np.uint8), 64),
            ("scaled", rng.integers(0, 256, (4, 32, 128, 128, 3), np.uint8),
             96))


def stage_kernel_verify(args, dev):
    """``resize_normalize_gather_cuda`` against its plain version on the
    card, at the mug layout (96 -> 64) and scaled's (128 -> 96). A wrong
    ingest kernel raises here and fails the run."""
    import torch

    from mocogan_tpu_torch.ops import preproc

    if dev.type != "cuda":
        return {"verified": False,
                "reason": f"the device is {dev.type}: the kernel runs only "
                          f"on cuda"}
    out = {"verified": True, "tol": KERNEL_TOL}
    for name, raw, size in _kernel_layouts():
        b, t, h, w, _ = raw.shape
        pool = torch.from_numpy(raw).to(dev)
        clip_ix = torch.arange(b, dtype=torch.int32, device=dev)
        frame_ix = torch.arange(t, dtype=torch.int32,
                                device=dev).expand(b, t).contiguous()
        rh, rw = preproc.resize_weights(h, w, size, dev)
        got = preproc.resize_normalize_gather_cuda(pool, clip_ix, frame_ix,
                                                   rh, rw)
        want = preproc.resize_normalize_gather_plain(pool, clip_ix,
                                                     frame_ix, rh, rw)
        err = float((got - want).abs().max())
        out[f"max_abs_err_{name}"] = err
        out[f"shape_{name}"] = [list(raw.shape), size]
        if not err <= KERNEL_TOL:
            raise AssertionError(
                f"resize_norm.cu differs from its plain version at the "
                f"{name} layout: max abs err {err} > {KERNEL_TOL}")
    out["max_abs_err"] = max(v for k, v in out.items()
                             if k.startswith("max_abs_err_"))
    return out


def stage_train(args, dev):
    """``time_single_step``: one train_step a call on a resident batch."""
    from mocogan_tpu_torch.utils import benchmarking

    cfg = _cfg(args.get("dtype", "float32"), args.get("batch_size"))
    out = benchmarking.time_single_step(
        cfg, args.get("steps", _steps()), args.get("warmup", _warmup()),
        args.get("windows", 3), device=dev)
    return {**out, "batch_size": cfg.train.batch_size}


def _scan(cfg, args, dev, k, n_clips):
    from mocogan_tpu_torch.utils import benchmarking

    out = benchmarking.time_cached_scan(
        cfg, k=k, reps=args.get("reps", 4), n_clips=n_clips,
        windows=args.get("windows", 2), device=dev)
    return {**out, "batch_size": cfg.train.batch_size, "k": k}


def stage_scan(args, dev):
    """``time_cached_scan``: the device-cached path, k steps a call, each
    gathering and resizing its batch in one launch of the ingest kernel."""
    cfg = _cfg(args.get("dtype", "float32"), args.get("batch_size"),
               args.get("overrides"))
    return _scan(cfg, args, dev, args.get("k", 16), args.get("n_clips", 64))


def stage_scaled(args, dev):
    """``scaled`` (96x96x32f, bf16, remat) at train.num_devices=1 on the
    device-cached path: batch 16 unless given, k 32, 32 clips."""
    cfg = _cfg(batch_size=args.get("batch_size", 16), name="scaled")
    return _scan(cfg, args, dev, args.get("k", 32), args.get("n_clips", 32))


def _generate_once(dev):
    """fp32 ``generate(PARITY_N, seed=PARITY_SEED)`` of the mug generator at
    the config's seed (noise drawn on the host), called twice: two numpy
    arrays."""
    from mocogan_tpu_torch.models import generator
    from mocogan_tpu_torch.train import state as train_state

    g = train_state.create(_cfg(), device=dev).nets["gen"]
    return [generator.generate(g, PARITY_N, seed=PARITY_SEED).cpu().numpy()
            for _ in range(2)]


def stage_parity(args, dev):
    """fp32 ``generate()`` at the golden recipe (mug, seed-0 init, n 2):
    twice on the device, which must be bit-equal, then the same call in a
    child on the CPU (``--device cpu``), within PARITY_TOL of the card.
    Writes its first clips to ``dump`` when asked (the CPU rerun)."""
    import tempfile

    import numpy as np

    from mocogan_tpu_torch.eval.parity import video_digest

    v1, v2 = _generate_once(dev)
    out = {"n": PARITY_N, "seed": PARITY_SEED, "digest": video_digest(v1),
           "deterministic": bool((v1 == v2).all())}
    if args.get("dump"):
        np.save(args["dump"], v1)
    if not out["deterministic"]:
        raise AssertionError(f"two generate() calls differ on {dev}: {out}")
    if dev.type == "cpu":
        return out
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        dump = os.path.join(td, "cpu.npy")
        cmd = [sys.executable, "-m", "mocogan_tpu_torch.bench", "--stage",
               "parity", "--stage-args",
               json.dumps({"dump": dump}),
               "--device", "cpu"]
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                           timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"the CPU rerun failed (rc {r.returncode}):"
                               f" {r.stderr[-800:]}")
        v_cpu = np.load(dump)
    out["cpu_rerun_seconds"] = round(time.perf_counter() - t0, 3)
    out["digest_cpu"] = video_digest(v_cpu)
    out["bitwise_equal_to_cpu"] = bool((v1 == v_cpu).all())
    out["max_abs_err_vs_cpu"] = float(np.abs(v1 - v_cpu).max())
    out["tol"] = PARITY_TOL
    if not out["max_abs_err_vs_cpu"] <= PARITY_TOL:
        raise AssertionError(f"generate() on {dev} against the CPU: {out}")
    return out


def stage_generate(args, dev):
    """``time_generate``: clips/s at each size of clips a call."""
    from mocogan_tpu_torch.utils import benchmarking

    cfg = _cfg()
    return {"clips_per_sec": {
        str(n): benchmarking.time_generate(cfg, n, args.get("reps", 10),
                                           args.get("windows", 3),
                                           device=dev)
        for n in args.get("sizes", (64, 256, 512))}}


STAGES = {
    "preflight": stage_preflight,
    "cpu_oracle": stage_cpu_oracle,
    "kernel_verify": stage_kernel_verify,
    "train": stage_train,
    "scan": stage_scan,
    "scaled": stage_scaled,
    "parity": stage_parity,
    "generate": stage_generate,
}


def _fake_fail(name: str) -> None:
    """BENCH_FAKE_FAIL_AFTER="stage:N:counterfile": that stage's first N
    runs go on, later ones exit 3 (a card that dies mid-run)."""
    spec = os.environ.get("BENCH_FAKE_FAIL_AFTER", "")
    if not spec:
        return
    sname, n, path = spec.split(":", 2)
    if sname != name:
        return
    count = 0
    if os.path.exists(path):
        with open(path) as f:
            count = int(f.read().strip() or 0)
    with open(path, "w") as f:
        f.write(str(count + 1))
    if count >= int(n):
        sys.exit(3)


def child_main(name: str, args: dict, device: str) -> None:
    """Run stage `name` in this process and print MARKER + its result."""
    if name in os.environ.get("BENCH_FAKE_HANG", "").split(","):
        time.sleep(100000)
    _fake_fail(name)
    import torch

    from mocogan_tpu_torch.ops import preproc
    from mocogan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cpu" if name == "cpu_oracle" else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tf32 = set_tf32(args.get("tf32", "off"))
    preproc.LAUNCHES["resize_norm"] = 0
    t0 = time.perf_counter()
    result = STAGES[name](args, dev)
    result.update(
        seconds_in_stage=round(time.perf_counter() - t0, 3), tf32=tf32,
        kernel_launches=preproc.LAUNCHES["resize_norm"],
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None))
    print(MARKER + json.dumps(result), flush=True)


# --------------------------------------------------------------------------
# The parent: calls nothing under torch.cuda, never touches the card (a
# wedged card can hang even in torch.cuda.is_available()).
# --------------------------------------------------------------------------

class Budget:
    def __init__(self, total: float):
        self.total = total
        self.t0 = time.time()

    def remaining(self) -> float:
        return self.total - (time.time() - self.t0)

    def elapsed(self) -> float:
        return time.time() - self.t0


def _stage_timeout(name: str) -> float:
    try:
        overrides = json.loads(os.environ.get("BENCH_STAGE_TIMEOUTS", "{}"))
    except ValueError:
        overrides = {}
    return float(overrides.get(name, STAGE_TIMEOUTS[name]))


def _kill_group(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_stage(name: str, args: dict, budget: Budget, diag: dict,
              diag_key: str | None = None, device: str = "cuda"):
    """Run one stage in a child process under the watchdog. Returns the
    stage's result, or None on a timeout, a failure or a skip, with the
    reason in ``diag[diag_key or name]``."""
    key = diag_key or name
    remaining = budget.remaining()
    if remaining < 20.0:
        diag[key] = {"skipped": "budget_exhausted"}
        print(f"[bench] skipping {key}: budget exhausted", file=sys.stderr)
        return None
    timeout = min(_stage_timeout(name), remaining)
    print(f"[bench] stage {key}: starting (timeout {timeout:.0f} s, budget "
          f"left {remaining:.0f} s)", file=sys.stderr, flush=True)
    cmd = [sys.executable, "-m", "mocogan_tpu_torch.bench", "--stage", name,
           "--stage-args", json.dumps(args), "--device", device]
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        proc.communicate()
        diag[key] = {"timeout": True, "timeout_sec": round(timeout, 1)}
        print(f"[bench] stage {key} TIMED OUT after {timeout:.0f} s "
              f"(killed)", file=sys.stderr)
        return None
    finally:
        # the stage's grandchildren share its process group
        _kill_group(proc)
    dt = time.time() - t0
    for line in reversed(stdout.splitlines()):
        if line.startswith(MARKER):
            diag[key] = {"ok": True, "seconds": round(dt, 1)}
            return json.loads(line[len(MARKER):])
    diag[key] = {"error": (stderr or stdout)[-800:], "rc": proc.returncode,
                 "seconds": round(dt, 1)}
    print(f"[bench] stage {key} failed (rc {proc.returncode}): "
          f"{(stderr or '')[-500:]}", file=sys.stderr)
    return None


def _flag(name: str) -> bool:
    return os.environ.get(name, "1") != "0"


class Health:
    """After two stage timeouts in a row the preflight runs again; if it
    fails too, the card is taken as dead and the remaining stages skip
    instead of each spending its timeout."""

    def __init__(self):
        self.consec_timeouts = 0
        self.dead = False
        self.rechecks = 0


def run_gpu_stage(name: str, args: dict, budget: Budget, diag: dict,
                  extra: dict, health: Health, device: str,
                  diag_key: str | None = None):
    key = diag_key or name
    if health.dead:
        diag[key] = {"skipped": "gpu_dead"}
        return None
    if health.consec_timeouts >= 2:
        health.rechecks += 1
        probe = run_stage("preflight", {}, budget, diag,
                          f"preflight_recheck{health.rechecks}", device)
        if probe and probe.get("ok"):
            health.consec_timeouts = 0
        else:
            health.dead = True
            extra["gpu_died_mid_run"] = True
            print("[bench] the card did not answer the re-probe after two "
                  "stage timeouts: skipping the remaining stages",
                  file=sys.stderr)
            diag[key] = {"skipped": "gpu_dead"}
            return None
    res = run_stage(name, args, budget, diag, key, device)
    if diag.get(key, {}).get("timeout"):
        health.consec_timeouts += 1
    elif res is not None:
        health.consec_timeouts = 0
    return res


def _kernel_check(kv, st: dict, extra: dict) -> str:
    if kv and kv.get("verified"):
        return "verified"
    if kv:
        return f"skipped:{kv.get('reason', 'not verified')}"
    if st.get("timeout"):
        return "stage_timeout"
    if st.get("skipped"):
        return f"skipped:{st['skipped']}"
    extra["kernel_error"] = st.get("error", "")[-400:]
    return "KERNEL_CHECK_FAILED"


def _round(x, nd=3):
    return None if x is None else round(x, nd)


def main(argv=None) -> int:
    """Run the stages and print the line; returns the exit code. With
    ``--stage`` (the parent's children), run that one stage instead."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu only for the CPU tests")
    ap.add_argument("--stage", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stage-args", default="{}", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.stage:
        child_main(a.stage, json.loads(a.stage_args), a.device)
        return 0
    device = a.device
    budget = Budget(float(os.environ.get("BENCH_BUDGET_SEC", "1200")))
    diag: dict = {}
    results: dict = {}
    extra: dict = {"results": results, "stages": diag}
    health = Health()

    def gpu(name, args, key=None):
        key = key or name
        res = run_gpu_stage(name, args, budget, diag, extra, health, device,
                            key)
        if res is not None:
            results[key] = res
        return res

    oracle = run_stage("cpu_oracle", {}, budget, diag)
    if oracle:
        results["cpu_oracle"] = oracle
    cpu_sps = oracle["steps_per_sec"] if oracle else None
    extra["cpu_oracle_steps_per_sec"] = _round(cpu_sps, 6)

    pre = run_stage("preflight", {}, budget, diag, device=device)
    gpu_ok = bool(pre and pre.get("ok"))
    extra["gpu_unresponsive"] = not gpu_ok
    extra["device"] = None
    if pre:
        results["preflight"] = pre
        extra["device"] = {k: pre.get(k) for k in (
            "device", "name", "power_limit", "smi", "torch", "cuda")}

    train = clips = None
    if gpu_ok:
        train = gpu("train", {"dtype": "float32", "tf32": "off"})
        gpu("train", {"dtype": "float32", "tf32": "default"},
            "train_tf32_default")
        kv = gpu("kernel_verify", {})
        extra["kernel_check"] = _kernel_check(
            kv, diag.get("kernel_verify", {}), extra)
        if _flag("BENCH_BF16"):
            gpu("train", {"dtype": "bfloat16"}, "train_bf16")
        if _flag("BENCH_PARITY"):
            gpu("parity", {})
        if _flag("BENCH_GENERATE"):
            sweep = gpu("generate", {"sizes": [64, 256, 512]})
            if sweep:
                clips = sweep["clips_per_sec"]["256"]["best"]
        if _flag("BENCH_SCAN"):
            for dtype in ("float32", "bfloat16"):
                gpu("scan", {"dtype": dtype, "k": 16}, f"scan_{dtype}")
            for b in (32, 64, 128):
                gpu("scan", {"dtype": "bfloat16", "k": 16, "batch_size": b},
                    f"scan_b{b}")
        if _flag("BENCH_BATCHES"):
            for b in (32, 64, 128):
                gpu("train", {"dtype": "bfloat16", "batch_size": b},
                    f"train_b{b}")
        if _flag("BENCH_SCALED"):
            gpu("scaled", {})
    else:
        extra["kernel_check"] = "skipped:gpu_unresponsive"
        print("[bench] no card answered the preflight: the line carries "
              "the CPU anchor only", file=sys.stderr)

    extra["tf32"] = {k: r["tf32"] for k, r in results.items()
                     if k not in ("preflight", "cpu_oracle")}
    extra["generate_clips_per_sec_256"] = _round(clips, 1)
    extra["budget"] = {"budget_sec": budget.total,
                       "elapsed_sec": round(budget.elapsed(), 1)}
    failed = sorted(k for k, d in diag.items()
                    if d.get("timeout") or "error" in d)
    if gpu_ok and extra["kernel_check"] == "KERNEL_CHECK_FAILED":
        failed = sorted(set(failed) | {"kernel_verify"})
    extra["failed_stages"] = failed
    value = _round(train["best"]) if train else None
    print(f"[bench] train {value} steps/s best (cpu oracle {cpu_sps}); "
          f"generate at 256: {clips} clips/s; failed {failed}; elapsed "
          f"{budget.elapsed():.0f} s", file=sys.stderr)
    print(json.dumps({
        "metric": "train_steps_per_sec_64x64x16f",
        "value": value,
        "unit": "steps/sec",
        "vs_baseline": (round(train["best"] / cpu_sps, 2)
                        if train and cpu_sps else None),
        "extra": extra,
    }), flush=True)
    return 1 if failed or not gpu_ok else 0


if __name__ == "__main__":
    sys.exit(main())
