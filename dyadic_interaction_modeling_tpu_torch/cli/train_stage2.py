"""CodeTalker stage-2 training, on the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.train_stage2 --synthetic \\
        [--device cpu] [--data-root DIR] [--lr 1e-4] [--w2v-layers N] [--epochs N] \\
        [--save-path DIR] [KEY VALUE ...]

The twin of ``dyadic_interaction_modeling_tpu/cli/train_stage2.py``. The
reference ships the model (``models/stage2.py``) but no training script;
this one trains it with the wav2vec2 conv extractor (stage2.py:20) and the
whole stage-1 VQ (stage2.py:46-47) frozen (``CODETALKER_FROZEN``:
``requires_grad_(False)``, left out of the optimizer), Adam (``--lr``, no
weight decay, no clip, as ``create_train_state`` gives it) on the motion
plus regression MSE, one clip a step. Each epoch prints the mean loss and
keeps the state_dict of the lowest (``best_model.pt`` under
``--save-path``).

Data: ``--synthetic`` makes 4 BIWI-shaped clips of 8 frames with Gaussian
audio of 8 * 533 + 400 samples (``default_rng(i)``), as the JAX CLI does;
without it the training split of the BIWI tree at ``--data-root`` (else
the config's ``data_root``, else ``./BIWI/``: ``wav/``, ``vertices_npy/``,
``templates.pkl``; the subjects from ``train_subjects`` / ``val_subjects``
/ ``test_subjects``, BIWI's usual ones by default) is read through
``BiwiDataset.read_data`` with the raw audio. ``--data-root`` is the
port's: the JAX CLI takes the tree from a config file only. Trailing
``KEY VALUE`` pairs override ``codetalker_defaults()``; ``--w2v-layers``
cuts the trunk's depth.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..config import codetalker_defaults
from ..data.datasets import (BIWI_EMOCA_TEST_SUBJECTS, BIWI_EMOCA_TRAIN_SUBJECTS,
                             BiwiDataset)
from ..data.synthetic import synthetic_biwi_dataset
from ..engine.train_state import make_optimizer
from ..models.codetalker import CODETALKER_FROZEN, CodeTalker
from ..models.wav2vec2 import W2VConfig
from ..utils.checkpoint import BestCheckpointKeeper
from .common import get_parser as common_parser
from .common import load_config

SYNTHETIC_CLIPS, SYNTHETIC_LEN = 4, 8


def get_parser():
    parser = common_parser("CodeTalker stage-2 training")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--w2v-layers", type=int, default=None,
                        help="the wav2vec2 trunk's depth (default: the base model's 12)")
    parser.add_argument("--data-root", type=str, default=None,
                        help="BIWI tree (wav/ vertices_npy/ templates.pkl)")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def make_stage2_step(model: CodeTalker, optimizer: torch.optim.Optimizer) -> Callable:
    """(audio, template, vertice, one_hot) -> the step's losses (device
    tensors): ``loss``, ``motion``, ``reg``."""

    def step(audio, template, vertice, one_hot) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        total, (motion, reg) = model(audio, template, vertice, one_hot)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "motion": motion.detach(), "reg": reg.detach()}

    return step


Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def synthetic_batches(cfg) -> List[Batch]:
    """The JAX CLI's clips, one a batch: (1, samples) audio, (1, V*3)
    template, (1, L, V*3) vertices, (1, n_subjects) one-hot."""
    items, _ = synthetic_biwi_dataset(n_clips=SYNTHETIC_CLIPS, length=SYNTHETIC_LEN,
                                      n_vertices=cfg.vertice_dim // 3)
    one_hot = np.eye(len(cfg.train_subjects.split()), dtype=np.float32)
    return [(np.random.default_rng(i).standard_normal(SYNTHETIC_LEN * 533 + 400)
             .astype(np.float32)[None], item["template"][None], item["vertice"][None],
             one_hot[i % one_hot.shape[0]][None]) for i, item in enumerate(items)]


def file_batches(cfg, data_root: str) -> List[Batch]:
    """The training split of the BIWI tree at ``data_root``, one clip a
    batch, as ``synthetic_batches``."""
    train, _, _, subjects = BiwiDataset.read_data(
        data_root, cfg.get("wav_path", "wav"),
        cfg.get("vertices_path", "vertices_npy"), cfg.get("template_file", "templates.pkl"),
        cfg.dataset, cfg.train_subjects, cfg.get("val_subjects", BIWI_EMOCA_TRAIN_SUBJECTS),
        cfg.get("test_subjects", BIWI_EMOCA_TEST_SUBJECTS), read_audio=True)
    ds = BiwiDataset(train, subjects["train"], "train", read_audio=True)
    return [(a[None], t[None], v[None], o[None])
            for a, v, t, o, _ in (ds[i] for i in range(len(ds)))]


def main(argv=None):
    args = get_parser().parse_args(argv)
    cfg = load_config(args, codetalker_defaults)
    batches = (synthetic_batches(cfg) if args.synthetic else
               file_batches(cfg, args.data_root or cfg.get("data_root", "./BIWI/")))
    if not batches:
        raise SystemExit("no training clips")
    w2v = W2VConfig(num_hidden_layers=args.w2v_layers) if args.w2v_layers else None
    torch.manual_seed(args.seed)
    model = CodeTalker(cfg, w2v).to(args.device).train()
    step = make_stage2_step(model, make_optimizer(model, args.lr, 0.0, CODETALKER_FROZEN))
    batches = [tuple(torch.as_tensor(x, device=args.device) for x in b) for b in batches]
    keeper = BestCheckpointKeeper(args.save_path or "./runs_stage2/model")
    for epoch in range(cfg.get("epochs", 100)):
        logs = [step(*b) for b in batches]
        mean = float(np.mean([float(lg["loss"]) for lg in logs]))
        print(f"Epoch {epoch}: loss {mean:.6f} (motion {float(logs[-1]['motion']):.6f} "
              f"reg {float(logs[-1]['reg']):.6f})", flush=True)
        if keeper.update(mean, model):
            print(f"Epoch {epoch}: new best {mean:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
