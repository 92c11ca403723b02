"""Stage-1 VQ-VAE tokenizer training (reference ``code/train_vq.py``), on
the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.train_vq \\
        [--synthetic] [--config FILE.yaml] [--device cpu] [--epochs N] \\
        [--save-path DIR] [--prefetch N] [KEY VALUE ...]

Builds the tokenizer that ``cfg.arch`` names (``models.get_model``): the
listener ``VQAutoEncoder`` of ``vq_listener_defaults()`` (hidden 384, 6 + 6
layers, 8 heads of 48, a 512 x 128 codebook), or with ``--config`` a
speaker config (``arch stage1_speaker_BIWI``) the audio-visual
``VQSpeakerAutoEncoder`` (hidden 768, 8 heads of 96, 8 codes a frame). Any
``in_dim`` above 56 trains on motion || audio with the split loss
(``calc_vq_loss_AV``). It trains from a seeded random init in fp32 on
single-stream clips, each batch dense and padded by repeating the last frame
to a power-of-two length of at most 1024 (``data.loader.vq_collate``).
Clips of 512 frames or more take K2/K3 in every attention layer
(``ops/transformer.py``). Each epoch it trains, validates and saves the
state_dict of the best validation ``rec_loss`` (``best_model.pt`` under
``--save-path``), which the SLM CLIs load with ``--speaker-vq`` /
``--listener-vq``. The run record goes beside it (``utils.observability``,
the JAX CLI's tags): ``scalars.jsonl`` with ``train_batch/loss``,
``train_batch/loss_2`` and ``learning_rate`` every ``print_freq`` steps and
``train/`` and ``val/`` ``rec_loss``, ``quant_loss`` and ``perplexity``
each epoch, and ``hparams.json``.

Data: with ``--synthetic``, synthetic ViCo-shaped clips (their listener
stream, or listener || audio for the audio-visual VQ); else the ViCo files
in the reference's layout, ``cfg.data_path`` (default
``../data/vico_processed_30fps``) and ``cfg.meta_data_path`` (default
``../data/RLD_data.csv``), the train split for training and the test split
for validation. The audio-visual VQ cannot train on those files: their
speaker stream (``ViCoSpeakerDataset``) is the 56-d speaker video alone, so
the run stops with both widths named (ROADMAP.md queue 3).

Reference quirk, kept: AdamW runs with torch's default weight decay 0.01,
not the config's 0.002 (train_vq.py:112); ``adamw_config_weight_decay True``
takes the config's. Trailing ``KEY VALUE`` pairs override the config
(``epochs``, ``base_lr``, ``batch_size``, widths). ``--mesh`` (JAX
``train_vq.py:109``) trains on several devices, one process each
(``parallel.MeshPlan``): ``batch_size`` stays the global batch, each rank
steps its slice of it, every rank validates on the whole validation set,
and rank 0 writes ``best_model.pt`` and the run record.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import merge_cfg_from_list, vq_listener_defaults
from ..data.datasets import ViCoListenerDataset, ViCoSpeakerDataset
from ..data.loader import PaddedBatchLoader, vq_collate
from ..data.synthetic import synthetic_vico_dataset
from ..engine.train_state import make_optimizer
from ..engine.vq_engine import make_vq_eval_step, make_vq_train_step, train_epoch, validate
from ..models import get_model
from ..utils.checkpoint import BestCheckpointKeeper
from ..utils.observability import run_writer
from .common import get_parser as common_parser
from .common import load_config, prefetched, state_dict_fn, training_mesh

MOTION_DIM = 56


def get_parser():
    return common_parser("train the stage-1 VQ-VAE")


def _defaults():
    """``vq_listener_defaults()`` with the training-only keys."""
    cfg = vq_listener_defaults()
    cfg.update(adamw_config_weight_decay=False, print_freq=500)
    return cfg


def vq_train_cfg(opts=()):
    """The defaults, then the ``KEY VALUE`` overrides."""
    return merge_cfg_from_list(_defaults(), list(opts)) if opts else _defaults()


def _synthetic(audio_visual: bool):
    """Each synthetic clip's listener stream, or listener || audio for the
    audio-visual VQ (the JAX CLI's ``_AV``); train and val share the set,
    as the JAX package's synthetic run does."""
    items = synthetic_vico_dataset(n_clips=32, min_len=24, max_len=64).items
    if audio_visual:
        return [(np.concatenate([li, comb[:, MOTION_DIM:]], axis=1), i)
                for i, (comb, li, *_) in enumerate(items)]
    return [(li, i) for i, (_, li, *_) in enumerate(items)]


def build_datasets(cfg, synthetic: bool, audio_visual: bool):
    if synthetic:
        data = _synthetic(audio_visual)
        return data, data
    cls = ViCoSpeakerDataset if audio_visual else ViCoListenerDataset
    path = cfg.get("data_path", "../data/vico_processed_30fps")
    meta = cfg.get("meta_data_path", "../data/RLD_data.csv")
    train, val = cls(path, meta, "train"), cls(path, meta, "test")
    if audio_visual:
        width = train[0][0].shape[1] if len(train) else MOTION_DIM
        raise SystemExit(
            f"the audio-visual VQ takes in_dim = {cfg.in_dim} features, but the ViCo "
            f"speaker files give {width}-d clips (the speaker video alone); the JAX "
            "package fails there too (ROADMAP.md queue 3)")
    return train, val


def _batches(loader, device):
    for dense in loader:
        yield torch.as_tensor(dense, device=device)


def main(argv=None):
    args = get_parser().parse_args(argv)
    plan, launched = training_mesh(args, main, argv)
    if launched is not None:
        return launched
    cfg = load_config(args, _defaults)
    audio_visual = cfg.in_dim > MOTION_DIM
    train_ds, val_ds = build_datasets(cfg, args.synthetic, audio_visual)
    torch.manual_seed(cfg.manual_seed)
    model = get_model(cfg).to(args.device)
    stepped = plan.shard_state(model) if plan else model
    # train_vq.py:112 passes no weight_decay to AdamW (torch's default 0.01)
    wd = cfg.weight_decay if cfg.adamw_config_weight_decay else 0.01
    optimizer = make_optimizer(model, cfg.base_lr, wd)
    step = make_vq_train_step(stepped, optimizer, cfg.quant_loss_weight, audio_visual)
    eval_step = make_vq_eval_step(model, cfg.quant_loss_weight, audio_visual)
    train_loader = prefetched(PaddedBatchLoader(train_ds, cfg.batch_size, shuffle=True,
                                                collate=vq_collate), args.prefetch)
    val_loader = PaddedBatchLoader(val_ds, cfg.batch_size_val, shuffle=False,
                                   collate=vq_collate)
    save_dir = args.save_path or "./runs_vq/model"
    keeper = BestCheckpointKeeper(save_dir)
    writer = run_writer(save_dir, hparams=cfg)
    steps_per_epoch = len(train_ds) // max(1, cfg.batch_size)
    try:
        for epoch in range(cfg.epochs):
            train_loader.set_epoch(epoch)
            batches = _batches(train_loader, args.device)
            logs = train_epoch(plan.batches(batches) if plan else batches, step, epoch,
                               cfg.print_freq, writer=writer,
                               step_offset=epoch * steps_per_epoch, lr=cfg.base_lr)
            val = validate(_batches(val_loader, args.device), eval_step)
            print(f"epoch {epoch}: train {logs} val "
                  + " ".join(f"{k} {v:.4f}" for k, v in val.items()), flush=True)
            for k in ("rec_loss", "quant_loss", "perplexity"):
                if k in logs:
                    writer.add_scalar(f"train/{k}", logs[k], epoch + 1)
                writer.add_scalar(f"val/{k}", val[k], epoch + 1)
            if keeper.update(val["rec_loss"], model, state_dict_fn(plan, model)):
                print(f"epoch {epoch}: new best rec_loss {val['rec_loss']:.4f}", flush=True)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
