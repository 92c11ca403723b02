"""Metric batteries for listener evaluation (reference ``mymetrics.py:7-120``).

A copy of ``print_metrics`` and ``print_metrics_full`` from
``dyadic_interaction_modeling_tpu/metrics/reporting.py``: FD, paired FD, MSE,
SID, variance, residual PCC and STS over the pose (0:6) and expression (6:56)
splits, and ``print_biwi_metrics`` (LVE and FDD of BIWI meshes). Returns the
values and prints them in the reference's format.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from .eval_utils import (
    calculate_activation_statistics,
    calculate_frechet_distance,
    calcuate_sid,
    sts,
)


def _fd_list(gt, pred, sl) -> float:
    fids = []
    for g, p in zip(gt, pred):
        mu1, s1 = calculate_activation_statistics(g[:, sl])
        mu2, s2 = calculate_activation_statistics(p[:, sl])
        fids.append(calculate_frechet_distance(mu1, s1, mu2, s2))
    return float(np.mean(fids))


def _paired_fd_list(gt, pred, x, sl) -> float:
    pfids = []
    for g, p, xx in zip(gt, pred, x):
        gmu, gcov = calculate_activation_statistics(
            np.concatenate([xx[:, sl], g[:, sl]], axis=-1))
        mu, cov = calculate_activation_statistics(
            np.concatenate([xx[:, sl], p[:, sl]], axis=-1))
        pfids.append(calculate_frechet_distance(gmu, gcov, mu, cov))
    return float(np.mean(pfids))


def print_metrics(y_true: Sequence[np.ndarray], y_pred: Sequence[np.ndarray],
                  x: Sequence[np.ndarray], verbose: bool = True) -> Dict[str, float]:
    """ViCo listener battery (mymetrics.py:7-88)."""
    gt, pred = list(y_true), list(y_pred)
    pose, exp = slice(0, 6), slice(6, None)
    out: Dict[str, float] = {}
    out["fid_pose"] = _fd_list(gt, pred, pose)
    out["fid_exp"] = _fd_list(gt, pred, exp)
    out["pfid_pose"] = _paired_fd_list(gt, pred, x, pose)
    out["pfid_exp"] = _paired_fd_list(gt, pred, x, exp)
    out["mse_pose"] = float(np.mean([np.mean((g[:, pose] - p[:, pose]) ** 2)
                                     for g, p in zip(gt, pred)]))
    out["mse_exp"] = float(np.mean([np.mean((g[:, exp] - p[:, exp]) ** 2)
                                    for g, p in zip(gt, pred)]))
    out["sid_pose"] = calcuate_sid(gt, pred, type="pose")
    out["sid_pose_gt"] = calcuate_sid(gt, gt, type="pose")
    out["sid_exp"] = calcuate_sid(gt, pred, type="exp")
    out["sid_exp_gt"] = calcuate_sid(gt, gt, type="exp")
    gt_c = np.concatenate(gt, axis=0).reshape(-1, 56)
    pred_c = np.concatenate(pred, axis=0).reshape(-1, 56)
    out["var_pose_gt"] = float(np.var(gt_c[:, pose].reshape(-1)))
    out["var_pose"] = float(np.var(pred_c[:, pose].reshape(-1)))
    out["var_exp_gt"] = float(np.var(gt_c[:, exp].reshape(-1)))
    out["var_exp"] = float(np.var(pred_c[:, exp].reshape(-1)))
    x_c = np.concatenate(x, axis=0)[:, 0:56]

    def pcc(a, b):
        return np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1]

    out["rpcc_pose"] = float(abs(pcc(gt_c[:, pose], x_c[:, pose])
                                 - pcc(pred_c[:, pose], x_c[:, pose])))
    out["rpcc_exp"] = float(abs(pcc(gt_c[:, exp], x_c[:, exp])
                                - pcc(pred_c[:, exp], x_c[:, exp])))
    out["sts_pose"] = sts(gt_c[:, pose], pred_c[:, pose])
    out["sts_exp"] = sts(gt_c[:, exp], pred_c[:, exp])
    if verbose:
        print("fid_pose: ", out["fid_pose"])
        print("fid_exp: ", out["fid_exp"])
        print("pfid_pose: ", out["pfid_pose"])
        print("pfid_exp: ", out["pfid_exp"])
        print("mse_pose: ", out["mse_pose"])
        print("mse_exp: ", out["mse_exp"])
        print("sid_pose: ", out["sid_pose"], out["sid_pose_gt"])
        print("sid_exp: ", out["sid_exp"], out["sid_exp_gt"])
        print("var_pose: ", out["var_pose_gt"], out["var_pose"])
        print("var_exp: ", out["var_exp_gt"], out["var_exp"])
        print("rpcc pose: ", out["rpcc_pose"])
        print("rpcc exp: ", out["rpcc_exp"])
        print("sts pose: ", out["sts_pose"])
        print("sts exp: ", out["sts_exp"])
    return out


def print_metrics_full(y_true, y_pred, x, verbose: bool = True) -> Dict[str, float]:
    """Full-56-dim variant (mymetrics.py:90-120)."""
    gt, pred = list(y_true), list(y_pred)
    sl = slice(None)
    out: Dict[str, float] = {}
    out["fid"] = _fd_list(gt, pred, sl)
    out["pfid"] = _paired_fd_list(gt, pred, x, sl)
    out["mse"] = float(np.mean([np.mean((g - p) ** 2) for g, p in zip(gt, pred)]))
    gt_c = np.concatenate(gt, axis=0).reshape(-1, 56)
    pred_c = np.concatenate(pred, axis=0).reshape(-1, 56)
    out["var_gt"] = float(np.var(gt_c.reshape(-1)))
    out["var"] = float(np.var(pred_c.reshape(-1)))
    if verbose:
        print("fid: ", out["fid"])
        print("pfid: ", out["pfid"])
        print("mse: ", out["mse"])
        print("var: ", out["var_gt"], out["var"])
    return out


def print_biwi_metrics(y_true: Sequence[np.ndarray], y_pred: Sequence[np.ndarray],
                       file_names: Sequence[str], templates: Mapping[str, np.ndarray],
                       mouth_map: Sequence[int], upper_map: Sequence[int],
                       n_vertices: int = 23370, verbose: bool = True) -> Dict[str, float]:
    """BIWI lip vertex error and upper-face dynamics deviation
    (mymetrics.py:122-182). ``templates``: subject id -> (V * 3,) template;
    ``mouth_map`` / ``upper_map``: the lve.txt / fdd.txt vertex lists."""
    mouth_map, upper_map = np.asarray(mouth_map), np.asarray(upper_map)
    gts, preds, std_diff = [], [], []

    def motion_std(motion):
        l2 = np.sum(np.square(motion[:, upper_map, :]), axis=2)  # (T, |upper|)
        return float(np.mean(np.std(l2, axis=0)))

    for yt, yp, name in zip(y_true, y_pred, file_names):
        v_gt = yt.reshape(-1, n_vertices, 3)
        v_pred = yp.reshape(-1, n_vertices, 3)[: v_gt.shape[0]]
        tmpl = np.asarray(templates[name.split("_")[0]]).reshape(1, n_vertices, 3)
        gts.append(v_gt)
        preds.append(v_pred)
        std_diff.append(motion_std(v_gt - tmpl) - motion_std(v_pred - tmpl))
    v_gt, v_pred = np.concatenate(gts, axis=0), np.concatenate(preds, axis=0)
    l2_mouth = np.sum(np.square(v_gt[:, mouth_map, :] - v_pred[:, mouth_map, :]), axis=2)
    lve = float(np.mean(np.max(l2_mouth, axis=1)))
    fdd = float(np.mean(std_diff))
    if verbose:
        print("Lip Vertex Error: {:.4e}".format(lve))
        print("FDD: {:.4e}".format(fdd))
    return {"lve": lve, "fdd": fdd}
