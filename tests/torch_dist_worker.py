"""One rank of the port's collectives on a gloo group, for
tests/test_torch_distributed.py.

    python tests/torch_dist_worker.py RANK WORLD RENDEZVOUS_FILE IN.npz OUT_DIR

Reads the inputs from ``IN.npz`` and a checkpoint saved at step 1 under
``OUT_DIR/ckpt``, runs device-level staging, the int8 reduction and the
resharded restore on CPU meshes over the ``WORLD`` (4) ranks, and writes
what this rank holds to ``OUT_DIR/rank<RANK>.npz``. Imports neither JAX nor
the reference package.
"""
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.core.staging import (device_replicate,  # noqa: E402
                                      device_shard, staged_restore)
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402


def run(rank: int, data, out_dir: str) -> dict:
    res = {}
    t = {k: torch.from_numpy(data[k]) for k in data.files}
    x = t["x"]
    data4 = make_mesh((4,), ("data",), "cpu")
    res["replicate_data4"] = device_replicate(
        data4, x[16 * rank:16 * (rank + 1)])
    grid = make_mesh((2, 2), ("data", "model"), "cpu")
    d = grid.get_local_rank("data")
    res["replicate_data2x2"] = device_replicate(grid, x[32 * d:32 * (d + 1)])
    shards = {int(k.split("_")[1]): data[k] for k in data.files
              if k.startswith("shard_")}
    res["staged_restore"] = staged_restore(data4, shards)
    res["device_shard"] = device_shard(grid, x, P("data", "model")).to_local()

    for name in ("x", "halves"):
        res[f"q_{name}"], res[f"scale_{name}"] = C.quantize_int8(t[name])
    res["cr_q"], res["cr_scale"], res["cr_err"] = C.compress_residual(
        t["g_w"], t["e_w"])
    pods = make_mesh((2, 2), ("pod", "data"), "cpu")
    res["psum_same"] = C.compressed_psum(x, pods, "pod")
    grads = {"w": t["g_w"], "b": {"c": t["g_c"]}}
    errors = {"w": t["e_w"], "b": {"c": t["e_c"]}}
    red, new_err = C.compressed_grad_allreduce(grads, errors, pods, "pod")
    res.update(red_w=red["w"], red_c=red["b"]["c"], err_w=new_err["w"],
               err_c=new_err["b"]["c"])
    zeros = C.init_error_state(grads)
    res["zeros_w"], res["zeros_c"] = zeros["w"], zeros["b"]["c"]
    res["psum_distinct2"] = C.compressed_psum(
        t["blocks"][pods.get_local_rank("pod")], pods, "pod")
    pods4 = make_mesh((4,), ("pod",), "cpu")
    res["psum_distinct4"] = C.compressed_psum(t["blocks"][rank], pods4, "pod")

    store = CheckpointStore(os.path.join(out_dir, "ckpt"))
    template = {"w": data["w"]}
    for name, mesh, spec in (("restore4", data4, P("data")),
                             ("restore2x2", grid, P("data", "model"))):
        back = store.restore_resharded(template, mesh, {"w": spec})["w"]
        res[f"{name}_local"] = back.to_local()
        res[f"{name}_full"] = back.full_tensor()
    return {k: v.numpy() for k, v in res.items()}


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rdzv, inputs, out_dir = sys.argv[3:6]
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        res = run(rank, np.load(inputs), out_dir)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


if __name__ == "__main__":
    main()
