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
JAX trainer. Settings not ported yet (``--mesh_docs > 1``,
``--checkpoint_backend orbax``, multi-host flags) raise
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
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
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
    if args.coordinator is not None or args.num_processes is not None:
        raise NotImplementedError(
            "multi-host training is not ported to evdr_tpu_torch yet "
            "(ROADMAP.md queue 1, 'Multi-GPU')")
    from evdr_tpu_torch.train.harness import run_training

    run_training(cfg, device=args.device)


if __name__ == "__main__":
    main()
