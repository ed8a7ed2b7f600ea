"""Training CLI of the torch port — the flags of ``evdr_tpu.train.cli`` plus
``--device``.

ProxyQ iterative liscore distillation (reference ``mainv2_iter_liscore.py``)
on the GPU:

    python -m evdr_tpu_torch.train.cli --datasets tabfquad --loss liscore \
        --query_root .../proxyq --teacher_root .../features --init_root .../S3E_init \
        --mfs 5 10 25 50 --max_steps 23460 --eval_every 200 --temp 0.1 --k 40

``--score_impl pallas`` (or ``auto``) scores the teacher precompute with K1's
float32 mode, ``--eval_impl auto`` (the default) evaluates with it; the
student is always scored by the plain differentiable ``maxsim_torch``.
``--device cpu`` runs the plain PyTorch path on the host. ``--aug
qnoise|mixup|hardtoken`` and ``--qat int8|int4|pq|opq`` (with
``--qat_start_frac``, ``--qat_select_all``, ``--qat_pq_m``) run as in the
JAX trainer. ``--mesh_docs N`` trains doc-sharded over the first N GPUs
(``parallel/train_sharded.py``). One process per GPU (or several on one
card over gloo) joins with ``--coordinator host:port --num_processes P
--process_id I --dist_backend nccl|gloo [--local_shards S]``, where
``--mesh_docs`` is the global shard count (P x S); only process 0 writes.
``--checkpoint_backend orbax`` is not ported and raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses

from evdr_tpu_torch.train.config import (TrainConfig, VALID_AUGS, VALID_LOSSES,
                                         VALID_TRAINERS)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    defaults = TrainConfig()
    p.add_argument("--datasets", type=str, nargs="+", required=True)
    p.add_argument("--query_root", type=str, default=defaults.query_root)
    p.add_argument("--teacher_root", type=str, default=defaults.teacher_root)
    p.add_argument("--init_root", type=str, default=defaults.init_root)
    p.add_argument("--mfs", type=int, nargs="+", default=defaults.mfs)
    p.add_argument("--use_labeled_split", action="store_true")
    p.add_argument("--out_root", type=str, default=defaults.out_root)
    p.add_argument("--name", type=str, default=defaults.name)
    p.add_argument("--seed", type=int, default=defaults.seed)

    p.add_argument("--trainer", type=str, default=defaults.trainer, choices=VALID_TRAINERS)
    p.add_argument("--loss", type=str, default=defaults.loss, choices=sorted(VALID_LOSSES))
    p.add_argument("--aug", type=str, default=defaults.aug, choices=VALID_AUGS)
    p.add_argument("--max_steps", type=int, default=defaults.max_steps)
    p.add_argument("--epochs", type=int, default=defaults.epochs)
    p.add_argument("--eval_every", type=int, default=defaults.eval_every)
    p.add_argument("--print_every", type=int, default=defaults.print_every)
    p.add_argument("--q_batch", type=int, default=defaults.q_batch)
    p.add_argument("--full_batch", action="store_true")

    p.add_argument("--opt", type=str, default=defaults.opt)
    p.add_argument("--lr", type=float, default=defaults.lr)
    p.add_argument("--weight_decay", type=float, default=defaults.weight_decay)

    p.add_argument("--temp", type=float, default=defaults.temp)
    p.add_argument("--k", type=int, default=defaults.k)
    p.add_argument("--lambda_list", type=float, default=defaults.lambda_list)
    p.add_argument("--lambda_score", type=float, default=defaults.lambda_score)
    p.add_argument("--lambda_pair", type=float, default=defaults.lambda_pair)
    p.add_argument("--lambda_info", type=float, default=defaults.lambda_info)
    p.add_argument("--list_temp", type=float, default=defaults.list_temp)
    p.add_argument("--info_temp", type=float, default=defaults.info_temp)
    p.add_argument("--alpha", type=float, default=defaults.alpha)
    p.add_argument("--eps", type=float, default=defaults.eps)
    p.add_argument("--lambda_weight", type=float, default=defaults.lambda_weight)

    p.add_argument("--q_noise_std", type=float, default=defaults.q_noise_std)
    p.add_argument("--mixup_alpha", type=float, default=defaults.mixup_alpha)
    p.add_argument("--lambda_mix", type=float, default=defaults.lambda_mix)
    p.add_argument("--virt_noise_std", type=float, default=defaults.virt_noise_std)
    p.add_argument("--lambda_aux", type=float, default=defaults.lambda_aux)
    p.add_argument("--aux_docs", type=int, default=defaults.aux_docs)

    p.add_argument("--save_period", type=int, default=defaults.save_period)
    p.add_argument("--debug_invariants", action="store_true")
    p.add_argument("--steps_per_dispatch", type=int,
                   default=defaults.steps_per_dispatch)
    p.add_argument("--chunk_p", type=int, default=defaults.chunk_p)
    p.add_argument("--score_impl", type=str, default=defaults.score_impl,
                   choices=("xla", "pallas", "auto"))
    p.add_argument("--eval_impl", type=str, default=defaults.eval_impl,
                   choices=("xla", "pallas", "auto"))
    p.add_argument("--no_precompute_teacher", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=defaults.checkpoint_every)
    p.add_argument("--checkpoint_backend", default=defaults.checkpoint_backend,
                   choices=("npz", "orbax"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export_packed", default=defaults.export_packed,
                   choices=("none", "float32", "bfloat16", "int8", "int4",
                            "pq", "opq"),
                   help="after training, also write best_ndcg5.packed.npz "
                        "in the packed SERVING format at this storage tier")
    p.add_argument("--qat", default=defaults.qat,
                   choices=("none", "int8", "int4", "pq", "opq"))
    p.add_argument("--qat_select_all", action="store_true")
    p.add_argument("--qat_pq_m", type=int, default=defaults.qat_pq_m)
    p.add_argument("--qat_start_frac", type=float,
                   default=defaults.qat_start_frac)
    p.add_argument("--mesh_docs", type=int, default=defaults.mesh_docs)
    p.add_argument("--coordinator", default=None,
                   help="multi-host training: process 0's host:port. "
                        "Requires --mesh_docs == the GLOBAL shard count and "
                        "shared storage for --out_root")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="multi-host: the process group's backend (default "
                        "nccl on a GPU, gloo on the CPU; several processes "
                        "on one GPU need gloo)")
    p.add_argument("--local_shards", type=int, default=1,
                   help="multi-host: doc shards a process holds")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises when there is "
                        "none), 'cpu' runs the plain PyTorch path")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    kwargs["precompute_teacher"] = not args.no_precompute_teacher
    kwargs["qat_select_post"] = not args.qat_select_all
    return TrainConfig(**kwargs).validate()


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    from evdr_tpu_torch.train.harness import run_training

    if args.coordinator is None and args.num_processes is None:
        run_training(cfg, device=args.device)
        return
    if cfg.mesh_docs <= 1:
        # without this, N processes would each silently run a FULL
        # duplicate unsharded training (followers discarding all writes)
        # while the user believes they launched one multi-host run
        raise SystemExit(
            "--coordinator/--num_processes requires --mesh_docs set to "
            "the GLOBAL device count (multi-host training shards the "
            "doc axis over every device)")
    import torch.distributed as dist

    from evdr_tpu_torch.engine import resolve_device
    from evdr_tpu_torch.parallel.multihost import (global_doc_mesh,
                                                   init_multihost)

    backend = args.dist_backend or (
        "nccl" if resolve_device(args.device).type == "cuda" else "gloo")
    # join the group before any device use
    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   backend)
    try:
        mesh = global_doc_mesh(args.local_shards, device=args.device)
        if mesh.size != cfg.mesh_docs:
            raise SystemExit(
                f"multi-host training shards over ALL global shards: pass "
                f"--mesh_docs {mesh.size} (got {cfg.mesh_docs})")
        run_training(cfg, mesh=mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
