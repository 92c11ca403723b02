"""What the CLI twins share: the parser, the config and the batch streams.

Counterpart of ``dyadic_interaction_modeling_tpu/cli/common.py:13-49``
(``get_parser``, ``load_config``; the reference's
``base/utilities.get_parser``): ``--config`` (a sectioned YAML, PyYAML
needed), ``--synthetic``, ``--epochs``, ``--save-path``, ``--prefetch`` and
trailing ``KEY VALUE`` overrides, plus the port's ``--device`` (the card
unless ``cpu`` is asked for). The JAX package's ``--mesh`` waits for the
port of ``parallel/`` (ROADMAP.md, queue 1), and its ``setup``
(compilation cache, logger) has no counterpart here.
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterable, Iterator, Optional

import torch

from ..config import CfgNode, load_cfg_from_cfg_file, merge_cfg_from_list
from ..data.loader import PrefetchLoader, slm_batch_from_collated


def get_parser(description: str = " ") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=None,
                        help="sectioned YAML config (needs PyYAML)")
    parser.add_argument("--synthetic", action="store_true",
                        help="run on synthetic data (smoke test / demo)")
    parser.add_argument("--epochs", type=int, default=None, help="override epoch count")
    parser.add_argument("--save-path", type=str, default=None)
    parser.add_argument("--prefetch", type=int, default=0,
                        help="background-thread batch prefetch depth "
                             "(data.loader.PrefetchLoader; 0 = off)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the kernels run on cuda, their plain "
                             "versions on cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return parser


def load_config(args, defaults_fn: Callable[[], CfgNode]) -> CfgNode:
    """The ``--config`` file (or the defaults), with every key of the defaults
    it lacks filled in, then the ``KEY VALUE`` overrides and ``--epochs``."""
    cfg = load_cfg_from_cfg_file(args.config) if args.config else defaults_fn()
    for k, v in defaults_fn().items():
        cfg.setdefault(k, v)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    if args.epochs is not None:
        cfg.epochs = args.epochs
    return cfg


def prefetched(loader, depth: int, transform: Optional[Callable] = None):
    """``loader`` behind a ``PrefetchLoader`` of ``depth`` batches (none when
    0)."""
    return PrefetchLoader(loader, depth, transform) if depth else loader


def slm_batches(loader: Iterable, device, with_names: bool = False,
                cache=None) -> Iterator:
    """``pad_collate`` batches as (src_v, tgt, src_a, mask) tensors on
    ``device``; with ``cache`` (an ``engine.pt_engine.VQTokenCache``) also
    the clips' (z_s, z_l) codes, with ``with_names`` also the clip names."""
    for collated in loader:
        batch = tuple(torch.as_tensor(x, device=device)
                      for x in slm_batch_from_collated(collated))
        if cache is not None:
            batch = batch + cache(batch, collated[5])
        yield batch + (collated[5],) if with_names else batch
