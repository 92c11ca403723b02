"""PIRender training (reference ``code/Pirender/train.py:38-110``), on the
GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.render_train \\
        --save-path ./runs_pirender [--synthetic | --data-root DIR [--feat-root DIR]] \\
        [--vgg-weights vgg19.pth] [--perceptual vgg19] [--device cpu] [--mesh data=N] \\
        [--debug N] [--speed-benchmark] [--prefetch N]

Counterpart of ``dyadic_interaction_modeling_tpu/cli/render_train.py``,
with every flag of it. The data, by branch:

* ``--synthetic``: two generated clips (descriptor 32, 2 mapping layers);
* ``--data-root`` holding ``train_list.txt``: the reference's prepared
  VoxCeleb LMDB (``render.data.VoxLmdbDataset``, 73-d windows);
* ``--data-root`` with ``--feat-root``: the ViCo render-finetune layout
  (``VoxLMDirDataset``, 58-d windows with ``decapirender``);
* ``--data-root`` alone: a directory of clip directories, each with
  ``frames/`` and ``coeffs/`` (``load_clip_dirs`` + ``FramePairDataset``).

It builds the ``FaceGenerator`` from a seeded random init, resumes from
``latest_checkpoint.txt`` under ``--save-path``, and trains the two-stage
schedule of ``render.trainer.FaceTrainer`` (the 2-hour wall-clock limit,
snapshot image grids, scalar logs under ``logs/``), writing reference-layout
``step_{N}.pt`` checkpoints (``{"net_G", "net_G_ema", "meta"}``) that
``cli.render_inference --checkpoint`` reads. ``--vgg-weights`` loads a
torchvision vgg19 state_dict (``.pth``) into the perceptual trunk; without
it the trunk runs at random init. ``--debug N`` runs the ``test_everything``
harness for N iterations instead. ``--mesh`` takes the data-parallel
layouts only (``auto``, ``data=N``): one process a device, each stepping its
slice of the ``--batch-size`` pairs, rank 0 writing. ``--use-spect`` stops
with the trainer's error (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..parallel import is_master
from ..render.data import synthetic_render_dataset
from ..render.generator import FaceGenerator
from ..render.trainer import FaceTrainer
from ..utils.logging import get_logger
from .common import MESH_HELP, prefetched, training_mesh


def load_vgg_weights(path: str):
    """A torchvision-format vgg19 state_dict (.pth), ``{'state_dict': ...}``
    accepted."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PIRender training")
    parser.add_argument("--save-path", type=str, default="./runs_pirender")
    parser.add_argument("--data-root", type=str, default=None,
                        help="dir of clip dirs, each with frames/ + coeffs/; or a prepared "
                             "LMDB root; or (with --feat-root) the VoxDataset_LM frame-dir root")
    parser.add_argument("--feat-root", type=str, default=None,
                        help="per-clip .pkl coefficient dir: the reference's VoxDataset_LM "
                             "layout (vox_dataset.py:21-168); --data-root is then the "
                             "person/clip frame-dir root")
    parser.add_argument("--frame-dir-prefix", type=str, default="",
                        help="feat-name -> frame-dir prefix ('vid_vico_videos_' for the "
                             "ViCo mode_split=2 layout, vox_dataset.py:252)")
    parser.add_argument("--no-decapirender", action="store_true",
                        help="VoxDataset_LM: [exp, pose] (56-d) instead of the shipped "
                             "[exp, 0, 0, pose] 58-d layout (face.yaml decapirender: 1)")
    parser.add_argument("--minimal-sample-distance", type=int, default=1)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--coeff-nc", type=int, default=58)
    parser.add_argument("--semantic-radius", type=int, default=13)
    parser.add_argument("--use-spect", action="store_true")
    parser.add_argument("--lmdb-multiplier", type=int, default=100,
                        help="person-list repetition for LMDB data (vox_dataset.py:370 "
                             "uses 100)")
    parser.add_argument("--pretrain-warp-iteration", type=int, default=2)
    parser.add_argument("--max-epochs", type=int, default=1)
    parser.add_argument("--steps-per-epoch", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--snapshot-iter", type=int, default=2)
    parser.add_argument("--logging-iter", type=int, default=1)
    parser.add_argument("--max-seconds", type=float, default=2 * 3600,
                        help="wall-clock limit (train.py:90-110)")
    parser.add_argument("--vgg-weights", type=str, default=None,
                        help="torchvision vgg19 state_dict (.pth); without it the "
                             "perceptual loss uses random VGG features")
    parser.add_argument("--perceptual", type=str, default="vgg19",
                        choices=["vgg19", "vgg16", "alexnet", "resnet50", "l1"],
                        help="perceptual trunk (reference perceptual.py:203-302; the "
                             "shipped face.yaml uses vgg19)")
    parser.add_argument("--prefetch", type=int, default=0,
                        help="background-thread batch prefetch depth (0 = off)")
    parser.add_argument("--debug", type=int, default=0, metavar="N",
                        help="run the test_everything debug harness for N iterations "
                             "instead of training (train.py:83-87, trainers/base.py:147-166)")
    parser.add_argument("--speed-benchmark", action="store_true",
                        help="log per-iteration data/step timing averages "
                             "(trainers/base.py:82-87,330-358)")
    parser.add_argument("--mesh", type=str, default=None,
                        help=MESH_HELP + "; the renderer takes 'auto' / 'data=N' only")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda unless cpu is asked for)")
    return parser


def build_dataset(args, logger):
    """(dataset, descriptor_nc, mapping_layers) for the data branch the
    flags pick; sets ``args.coeff_nc`` from the data."""
    if args.synthetic:
        ds = synthetic_render_dataset(n_clips=2, frames_per_clip=8, resolution=args.resolution,
                                      coeff_dim=args.coeff_nc,
                                      semantic_radius=args.semantic_radius)
        return ds, 32, 2
    if args.feat_root:
        from ..render.data import VoxLMDirDataset

        if not args.data_root:
            raise SystemExit("--feat-root needs --data-root <frame-dir root>")
        ds = VoxLMDirDataset(args.data_root, args.feat_root, resolution=args.resolution,
                             semantic_radius=args.semantic_radius,
                             decapirender=not args.no_decapirender,
                             minimal_sample_distance=args.minimal_sample_distance,
                             multiplier=args.lmdb_multiplier,
                             frame_dir_prefix=args.frame_dir_prefix)
        args.coeff_nc = ds[0]["source_semantics"].shape[0]
        logger.info(f"VoxDataset_LM layout: {len(set(ds.person_ids))} clips, "
                    f"coeff_nc={args.coeff_nc}")
        return ds, 256, 3
    if args.data_root and os.path.isfile(os.path.join(args.data_root, "train_list.txt")):
        from ..render.data import VoxLmdbDataset

        ds = VoxLmdbDataset(args.data_root, resolution=args.resolution,
                            semantic_radius=args.semantic_radius,
                            multiplier=args.lmdb_multiplier)
        args.coeff_nc = 73  # transform_semantic's output (vox_dataset.py:449-459)
        logger.info(f"LMDB data: {len(ds.video_items)} videos, "
                    f"{len(set(ds.person_ids))} persons")
        return ds, 256, 3
    if not args.data_root:
        raise SystemExit("pass --data-root <dir of clip dirs with frames/ + coeffs/, or a "
                         "prepared LMDB root with train_list.txt> or --synthetic")
    from ..render.data import FramePairDataset, load_clip_dirs

    clips = load_clip_dirs(args.data_root, resolution=args.resolution)
    if not clips:
        raise SystemExit(f"no usable clips under {args.data_root}")
    args.coeff_nc = clips[0]["coeffs"].shape[-1]
    logger.info(f"loaded {len(clips)} clips (coeff_nc={args.coeff_nc})")
    return FramePairDataset(clips, semantic_radius=args.semantic_radius), 256, 3


def main(argv=None):
    args = get_parser().parse_args(argv)
    plan, launched = training_mesh(args, main, argv)
    if launched is not None:
        return launched
    logger = get_logger()
    ds, desc_nc, mapping_layers = build_dataset(args, logger)
    # the JAX CLI draws a batch of 2 to initialise its params; drawn here
    # too, so the training batches are the same
    next(ds.batches(2, 1))
    torch.manual_seed(0)
    model = FaceGenerator(flame_coeff_nc=args.coeff_nc, coeff_nc=73, descriptor_nc=desc_nc,
                          mapping_layers=mapping_layers, use_spect=args.use_spect
                          ).to(args.device)
    vgg = load_vgg_weights(args.vgg_weights) if args.vgg_weights else None
    trainer = FaceTrainer(model, pretrain_warp_iteration=args.pretrain_warp_iteration,
                          vgg_state_dict=vgg, perceptual_network=args.perceptual,
                          save_dir=args.save_path, max_seconds=args.max_seconds, logger=logger)
    if trainer.load_latest():
        logger.info(f"resumed from iteration {trainer.iteration}")
    if plan:
        trainer.shard_with(plan)
        logger.info(f"training on a {plan.describe()}")

    def batches():
        # a fresh generator (and prefetch) an epoch: ds.batches is single-use
        b = prefetched(ds.batches(args.batch_size, args.steps_per_epoch), args.prefetch)
        return plan.batches(b) if plan else b

    if args.debug:
        out = trainer.test_everything(batches, iterations=args.debug)
        if is_master():
            logger.info(f"debug harness done at iteration {trainer.iteration}: {out}")
        return trainer
    trainer.train(batches, max_epochs=args.max_epochs, snapshot_iter=args.snapshot_iter,
                  logging_iter=args.logging_iter, speed_benchmark=args.speed_benchmark)
    logger.info(f"done at iteration {trainer.iteration}; checkpoints + logs under "
                f"{args.save_path}")
    return trainer


if __name__ == "__main__":
    main()
