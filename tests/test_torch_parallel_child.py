"""One rank of a 2-process gloo world on the CPU, for
``tests/test_torch_parallel.py``; it holds no tests.

Run:  python tests/test_torch_parallel_child.py RANK WORLD STORE IN OUT

The rank joins the world through the file store STORE, reads the inputs
the parent wrote to IN (``torch.save``), runs every scenario it names on
its rows of the global batch and writes the results to OUT. ``run`` is
also what the parent calls with ``mesh=None`` for the one-process
reference on the global batch. Neither JAX nor the JAX package is
imported here: what the parent derives from JAX arrives as tensors.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mocogan_tpu_torch import get_config  # noqa: E402
from mocogan_tpu_torch.data.pipeline import HostFeed  # noqa: E402
from mocogan_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mocogan_tpu_torch.train import state as tstate  # noqa: E402
from mocogan_tpu_torch.train import step as tstep  # noqa: E402

# the tiny geometry of conftest.tiny_cfg (global batch 8, 4 per rank)
TINY = {"model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 8, "train.steps_per_call": 1,
        "data.device_cache": False}
STEPS = 3       # train_step scenarios; the k-step paths run one call of 2

# scenario -> (config, overrides, path)
SCENARIOS = {
    "simultaneous": ("mug", {}, "step"),
    "sequential": ("mug", {"train.update_order": "sequential"}, "step"),
    "categorical": ("categorical", {"model.n_classes": 4}, "step"),
    "remat": ("mug", {"model.remat": True}, "step"),
    "cached": ("mug", {"train.steps_per_call": 2}, "cached"),
    "host_fed": ("mug", {"train.steps_per_call": 2}, "host_fed"),
    "jax": ("mug", {}, "jax"),
}


def config(name):
    cfg_name, kw, _ = SCENARIOS[name]
    return get_config(cfg_name, **{**TINY, **kw})


def _flat_state(state):
    """{"<net>.<name>": tensor} of params and BN buffers."""
    return {f"{n}.{k}": v.detach().clone()
            for n, net in state.nets.items()
            for k, v in net.state_dict().items()}


def _run_steps(state, name, inputs, mesh):
    """The path of scenario `name`: a list of per-call metric dicts and,
    after the first call, the state's tensors."""
    path = SCENARIOS[name][2]
    calls, first = [], None
    if path in ("step", "jax"):
        real = pmesh.local_batch_slice(mesh, inputs["real"]) if mesh \
            else inputs["real"]
        labels = None
        if state.cfg.model.conditional:
            labels = pmesh.local_batch_slice(mesh, inputs["labels"]) \
                if mesh else inputs["labels"]
        for i in range(1 if path == "jax" else STEPS):
            noise = (tstep.shard_draws(inputs["jax_draws"], mesh)
                     if path == "jax" else None)
            calls.append(tstep.train_step(state, real, noise, labels, mesh))
            if i == 0:
                first = _flat_state(state)
    elif path == "cached":
        calls.append(tstep.cached_multi_train_step(
            state, inputs["pool"], inputs["lengths"], 2, mesh=mesh))
        first = _flat_state(state)
    else:
        feed = HostFeed(iter(inputs["batches"]), 2, torch.device("cpu"),
                        depth=1, mesh=mesh)
        try:
            stack = feed.next()
            if mesh is not None:
                whole = torch.stack([torch.from_numpy(b["raw"])
                                     for b in inputs["batches"]])
                lb = whole.shape[1] // mesh.world_size
                assert torch.equal(feed.last_global[0], whole)
                assert torch.equal(stack[0],
                                   whole[:, mesh.rank * lb:][:, :lb])
        finally:
            feed.close()
        calls.append(tstep.multi_train_step(state, *stack, mesh=mesh))
        first = _flat_state(state)
    return [{k: float(v) for k, v in m.items()} for m in calls], first


def run(name, inputs, mesh=None):
    """Scenario `name` on this rank's rows (the global batch without a
    mesh): {"metrics": per-call metric dicts, "grads": {net: {param:
    grad}} of step 0 as the update applied them, "first": params and BN
    buffers after the first call, "last": after the last}."""
    cfg = config(name)
    state = tstate.create(cfg, device="cpu", mesh=mesh)
    if name == "jax":
        for n, net in state.nets.items():
            net.load_state_dict(inputs["jax_state"][n])
        tstate.check_replicated(state, mesh)
    grads = {}
    update = tstep._update

    def spy(st, names, g):
        if st.step == 0:
            grads.update({n: {k: v.clone() for k, v in g[n].items()}
                          for n in names})
        update(st, names, g)

    tstep._update = spy
    try:
        metrics, first = _run_steps(state, name, inputs, mesh)
    finally:
        tstep._update = update
    return {"metrics": metrics, "grads": grads, "first": first,
            "last": _flat_state(state)}


def mismatch(mesh):
    """True when the replication check raised on this rank after rank 1
    nudged one parameter."""
    state = tstate.create(config("simultaneous"), device="cpu", mesh=mesh)
    if mesh.rank == 1:
        with torch.no_grad():
            next(state.nets["gen"].parameters()).view(-1)[0] += 1e-3
    try:
        tstate.check_replicated(state, mesh)
    except RuntimeError:
        return True
    return False


def main(argv):
    rank, world, store, inp, out = argv
    torch.set_num_threads(1)
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    assert pmesh.initialize_distributed(
        "cpu", init_method="file://" + store)
    try:
        mesh = pmesh.make_mesh(int(world), 1, "cpu")
        assert mesh.collective and mesh.rank == int(rank)
        inputs = torch.load(inp, weights_only=False)
        res = {name: run(name, inputs, mesh) for name in inputs["scenarios"]}
        res["mismatch_raised"] = mismatch(mesh)
        torch.save(res, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
