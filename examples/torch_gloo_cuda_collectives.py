"""Which collectives gloo carries for CUDA tensors when several ranks share
one card, each tried on 4 ranks of its own (a crash ends only its world).

    python examples/torch_gloo_cuda_collectives.py

NCCL refuses two ranks on one device, so a mesh of ranks sharing the card
runs on gloo.  Tried: the c10d calls (barrier, broadcast, all-reduce,
all-gather, all-gather into a tensor, reduce-scatter, all-to-all, an
all-gather on a sub-group), the functional collectives DTensor's
redistribution calls (all-reduce; all-gather of a CPU and of a CUDA
tensor), and a DTensor gathered whole on a 1-D and a 2x2 mesh.  Prints one
line a collective, "ok" with its seconds or the way its world ended, and
the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

WORLD = 4
CASES = ("barrier", "broadcast", "all_reduce", "all_gather",
         "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single", "subgroup_all_gather", "functional_all_reduce",
         "functional_all_gather_cpu", "functional_all_gather_cuda",
         "dtensor_1d_full_tensor", "dtensor_2x2_full_tensor")


def collective(rank: int, world: int, which: str) -> str:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Shard, distribute_tensor
    torch.cuda.set_device(0)
    x = torch.full((8, 4), float(rank + 1), device="cuda")
    if which == "barrier":
        dist.barrier()
    elif which == "broadcast":
        dist.broadcast(x, 0)
    elif which == "all_reduce":
        dist.all_reduce(x)
    elif which == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    elif which == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(8 * world, 4, device="cuda"),
                                    x)
    elif which == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(8 // world, 4, device="cuda"),
                                   x)
    elif which == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif which == "subgroup_all_gather":
        groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        dist.all_gather_into_tensor(torch.empty(16, 4, device="cuda"), x,
                                    group=groups[rank // 2])
    elif which == "functional_all_reduce":
        x = fc.all_reduce(x, "sum", group=dist.group.WORLD)
    elif which == "functional_all_gather_cpu":
        x = fc.all_gather_tensor(x.cpu(), 0, group=dist.group.WORLD)
    elif which == "functional_all_gather_cuda":
        x = fc.all_gather_tensor(x, 0, group=dist.group.WORLD)
    else:
        from torch.distributed.device_mesh import init_device_mesh
        shape = (world,) if which == "dtensor_1d_full_tensor" else (2, 2)
        mesh = init_device_mesh("cuda", shape)
        d = distribute_tensor(torch.randn(8, 8, device="cuda"), mesh,
                              [Shard(0)] * len(shape), src_data_rank=None)
        x = d.full_tensor()
    torch.cuda.synchronize()
    return f"ok, sum {float(x.sum())}"


def main() -> int:
    from repro_torch.testing.ranks import run_ranks
    import torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}; {WORLD} gloo ranks on one "
          f"card")
    for which in CASES:
        t0 = time.perf_counter()
        try:
            res = run_ranks(f"{pathlib.Path(__file__).stem}:collective",
                            WORLD, which, backend="gloo", timeout=60)
            what = res[0]
        except (RuntimeError, TimeoutError) as e:
            what = str(e).splitlines()[0]
        print(f"{which:28s} {what} ({time.perf_counter() - t0:.1f} s with "
              f"the spawn)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
