"""The host-bound timers of ``chip_smoke.py`` phase 15, in turns, on the
card: to compare checkouts, and to see what a phase leaves behind.

    python -m mocogan_tpu_torch.utils.timer_turns ROOT [ROOT ...]
    python -m mocogan_tpu_torch.utils.timer_turns --around-data-parallel ROOT

ROOT is a checkout of the repository. For each ROOT, in the order given, a
fresh process imports ROOT's ``mocogan_tpu_torch`` and times, as phase 15
does and with TF32 off: the bf16 recipe's ``time_cached_scan`` (mug,
batch 32, bf16, label smoothing 0.1; k 16, reps 4, 3 windows),
``time_generate`` at 16 clips (reps 10, 3 windows) and mug fp32's
``time_cached_scan``. One JSON line of medians a process. Give two
checkouts as A B B A to compare them on one card.

With --around-data-parallel: the timers in this process twice and in a
fresh process, then ROOT's ``chip_smoke.py`` phase 13 in this process at
full width (its mug and `scaled` stores rendered here), then the timers
in this process right after it, twice, in a fresh process, and in this
process 60 s later.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def timers(device) -> dict:
    """Medians of the three timers on `device`."""
    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.utils import benchmarking as bm

    bf16 = get_config("mug", **{"model.compute_dtype": "bfloat16",
                                "train.batch_size": 32,
                                "train.label_smoothing": 0.1})
    mug = get_config("mug")
    return {
        "bf16_recipe_cached_scan": bm.time_cached_scan(
            bf16, 16, 4, 64, 3, device=device)["median"],
        "mug_fp32_generate_16": bm.time_generate(
            mug, 16, 10, 3, device=device)["median"],
        "mug_fp32_cached_scan": bm.time_cached_scan(
            mug, 16, 4, 64, 3, device=device)["median"]}


def _card():
    import torch

    from mocogan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(dev)
    return dev


def _fresh(root: str, what: str) -> None:
    """The timers in a fresh process that imports root's package (this
    file's functions, run there: root may predate it)."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {os.path.abspath(root)!r})\n"
            "t = {'__name__': 'timer_turns'}\n"
            f"exec(open({os.path.abspath(__file__)!r}).read(), t)\n"
            f"print(json.dumps({{'what': {what!r}, 'root': {root!r}, "
            "**t['timers'](t['_card']())}), flush=True)\n")
    subprocess.run([sys.executable, "-c", code], check=True)


def _around_data_parallel(root: str) -> None:
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.data import clips, synthetic
    from mocogan_tpu_torch.ops import preproc

    dev = _card()

    def here(what):
        print(json.dumps({"what": what, **timers(dev)}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _fresh(root, "fresh, before")
    here("before")
    here("before, again")
    with tempfile.TemporaryDirectory() as tmp:
        store = synthetic.write_store(os.path.join(tmp, "store"), clips=96,
                                      frames=32,
                                      size=get_config("mug").data.raw_size)
        sc = get_config("scaled")
        sc_dir = synthetic.write_store(
            os.path.join(tmp, "store_scaled"), clips=96,
            frames=sc.model.video_length + 4, size=sc.data.raw_size)
        cfg = get_config("mug", **{"data.data_dir": store})
        pool_np, lengths_np, _ = clips.load_pool(store)
        pool = torch.from_numpy(pool_np).to(dev)
        lengths = torch.from_numpy(lengths_np)
        m = cfg.model
        rh, rw = preproc.resize_weights(pool.shape[2], pool.shape[3],
                                        m.image_size, dev)
        plans = cs._plans(lengths, 8, cfg.train.batch_size, m.video_length,
                          dev)
        t0 = time.perf_counter()
        cs._data_parallel({"data.data_dir": store}, pool, lengths, rh, rw,
                          plans, cs.RATES.get(smi.rsplit(",", 1)[0].strip()),
                          smi, tmp, sc_dir)
        print(f"[timer_turns] phase 13 took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del pool, plans
    here("after")
    here("after, again")
    _fresh(root, "fresh, after")
    time.sleep(60)
    here("60 s after")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("roots", nargs="+", metavar="ROOT")
    ap.add_argument("--around-data-parallel", action="store_true",
                    help="one ROOT: the timers before and after its "
                         "chip_smoke.py phase 13")
    args = ap.parse_args(argv)
    _card()                                   # refuse a missing card here
    if args.around_data_parallel:
        if len(args.roots) != 1:
            ap.error("--around-data-parallel takes one ROOT")
        _around_data_parallel(args.roots[0])
        return
    for i, root in enumerate(args.roots):
        _fresh(root, f"turn {i + 1}")


if __name__ == "__main__":
    main()
