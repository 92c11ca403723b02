"""Offline preprocessing - the numeric cores of the reference's scripts.

Counterpart of ``dyadic_interaction_modeling_tpu/data/preprocessing.py``,
numpy in and numpy out:

* CANDOR transcript windowing with the +1-frame listener REACT_TIME shift and
  50 -> 5 fps audio average-pooling (reference ``preprocessing.py``),
* ViCo: HuBERT 50 -> 30 fps ``downsample_mean`` + EMOCA pose+exp per frame,
  min-length alignment (``vico_preprocessing.py``),
* L2L-format exporters: 64-frame windows with LANCZOS-resized
  mel-spectrogram audio at 4x frame rate
  (``vico_preprocessing_l2l.py:26-41,171-203``, ``l2l_preprocessing_l2l.py``,
  ``elp_preprocessing.py``),
* video L/R splitter (``preprocess_deception.py``; OpenCV, imported where
  it is used),
* voca frame-copy (``voca_preprocessing.py``).

The mel spectrogram is numpy with librosa's defaults (hann window, centered
reflect padding, power 2.0, slaney mel filterbank); its LANCZOS resize in
``load_melspec_features`` goes through Pillow, imported where it is used.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

REACT_TIME = 0.2  # 200 ms => +1 frame at 5 fps (preprocessing.py:7)


# ---------------------------------------------------------------------------
# rate conversion
# ---------------------------------------------------------------------------


def downsample_mean(array: np.ndarray, factor: float = 0.6) -> np.ndarray:
    """Blocked mean downsampling (vico_preprocessing.py:7-19).

    QUIRK kept: the reference uses ``window_size = int(t / new_t)`` so with
    factor 0.6 the windows cover only the first ``new_t * window_size``
    frames (tail ignored).
    """
    t, d = array.shape
    new_t = int(t * factor)
    window = int(t / max(new_t, 1))
    out = np.zeros((new_t, d), dtype=np.float64)
    for i in range(new_t):
        out[i] = np.mean(array[i * window: i * window + window], axis=0)
    return out


def avg_pool_audio(audio_feats: np.ndarray, factor: int = 10) -> np.ndarray:
    """50 fps -> 5 fps by averaging blocks of 10 (preprocessing.py:23-25).

    Truncates to a multiple of ``factor`` first (the reference relies on the
    input already being divisible)."""
    t = (audio_feats.shape[0] // factor) * factor
    return audio_feats[:t].reshape(-1, factor, audio_feats.shape[1]).mean(axis=1)


# ---------------------------------------------------------------------------
# mel spectrogram (librosa.feature.melspectrogram equivalent)
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    # slaney scale
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_step = np.log(6.4) / 27.0
    above = f >= 1000.0
    mel = np.where(above, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step, mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_step = np.log(6.4) / 27.0
    above = m >= 15.0
    return np.where(above, 1000.0 * np.exp(log_step * (m - 15.0)), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank (librosa.filters.mel)."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    return weights * enorm[:, None]


def melspectrogram(waveform: np.ndarray, sr: int = 16000,
                   win_length: Optional[int] = None,
                   hop_length: Optional[int] = None,
                   n_fft: Optional[int] = None, n_mels: int = 128) -> np.ndarray:
    """Power mel spectrogram with librosa default semantics (hann window,
    centered reflect padding). Returns (n_mels, frames)."""
    win_length = win_length or int(0.025 * sr)
    hop_length = hop_length or int(0.010 * sr)
    n_fft = n_fft or 2 ** int(np.ceil(np.log2(win_length)))
    pad = n_fft // 2
    x = np.pad(np.asarray(waveform, np.float64), pad, mode="reflect")
    window = np.hanning(win_length + 1)[:-1]
    # center the window inside the FFT frame like librosa
    w = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    w[off: off + win_length] = window
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[idx] * w[None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2  # power
    mel = mel_filterbank(sr, n_fft, n_mels) @ spec.T
    return mel


def load_melspec_features(waveform: np.ndarray, num_frames: int,
                          sr: int = 16000) -> np.ndarray:
    """Reference ``load_melspec`` (vico_preprocessing_l2l.py:26-41): mel
    spectrogram LANCZOS-resized along time to ``4 * num_frames`` columns.
    Returns (n_mels, 4 * num_frames)."""
    from PIL import Image

    s = melspectrogram(waveform, sr).astype(np.float32)
    im = Image.fromarray(s)
    im = im.resize((num_frames * 4, s.shape[0]), Image.LANCZOS)
    return np.array(im)


# ---------------------------------------------------------------------------
# EMOCA frame-dir readers
# ---------------------------------------------------------------------------


def read_emoca_frames(frame_root: str, order: str = "pose_exp",
                      with_detail: bool = False) -> np.ndarray:
    """Stack per-frame EMOCA npy coefficients.

    order='pose_exp' (vico_preprocessing.py:68-77: 56-d pose+exp) or
    'exp_pose_detail' (the l2l exporters, vico_preprocessing_l2l.py:150-159).
    Frame dirs starting with '0' are consumed in sorted order like the
    reference."""
    frames = []
    for d in sorted(os.listdir(frame_root)):
        if not d.startswith("0"):
            continue
        fd = os.path.join(frame_root, d)
        exp = np.load(os.path.join(fd, "exp.npy"))
        pose = np.load(os.path.join(fd, "pose.npy"))
        if order == "pose_exp":
            frames.append(np.concatenate([pose, exp], axis=0))
        else:
            parts = [exp, pose]
            if with_detail:
                parts.append(np.load(os.path.join(fd, "detail.npy")))
            frames.append(np.concatenate(parts, axis=0))
    return np.asarray(frames)


# ---------------------------------------------------------------------------
# dataset assembly
# ---------------------------------------------------------------------------


def candor_utterance_windows(transcript_rows: Sequence[Sequence],
                             audio_feats_50fps: np.ndarray,
                             video_feats: Mapping[str, Mapping[str, np.ndarray]],
                             fps: int = 5) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """CANDOR utterance windowing (preprocessing.py:38-82).

    audio is average-pooled 50 -> 5 fps; the listener window is shifted +1
    frame (REACT_TIME 0.2 s). ``video_feats[speaker][frame_idx_str]`` holds
    per-frame 56-d features keyed by zero-padded frame index.
    Returns {utterance_id: {'speaker': {...}, 'listener': {...}}}.
    """
    audio5 = avg_pool_audio(audio_feats_50fps, 10)
    speakers = sorted(set(r[1] for r in transcript_rows))
    out = {}
    for row in transcript_rows:
        utterance_id, speaker_id, start_time, end_time = row[0], row[1], float(row[2]), float(row[3])
        listener_id = speakers[1] if speaker_id == speakers[0] else speakers[0]
        s0, s1 = int(start_time * fps), int(end_time * fps)
        l0, l1 = s0 + 1, s1 + 1
        try:
            sp_video = np.asarray([video_feats[speaker_id][str(i).zfill(6)]
                                   for i in range(s0, s1)])
            li_video = np.asarray([video_feats[listener_id][str(i).zfill(6)]
                                   for i in range(l0, l1)])
        except KeyError:
            continue  # reference's broad except: skip incomplete utterances
        out[str(utterance_id)] = {
            "speaker": {"audio": audio5[s0:s1], "video": sp_video},
            "listener": {"video": li_video},
        }
    return out


def vico_process_clip(audio_feats_50fps: np.ndarray,
                      speaker_frames: np.ndarray,
                      listener_frames: np.ndarray) -> Dict[str, np.ndarray]:
    """ViCo clip assembly (vico_preprocessing.py:58-116): audio 50 -> 30 fps
    via downsample_mean(0.6), all three streams cut to the minimum length."""
    audio30 = downsample_mean(audio_feats_50fps, 0.6)
    n = min(audio30.shape[0], speaker_frames.shape[0], listener_frames.shape[0])
    return {
        "audio": audio30[:n].astype(np.float32),
        "video_speaker": np.asarray(speaker_frames[:n], np.float32),
        "video_listener": np.asarray(listener_frames[:n], np.float32),
    }


def l2l_export_windows(video_speaker: np.ndarray, video_listener: np.ndarray,
                       waveform: np.ndarray, file_id: str,
                       num_frames: int = 64) -> Dict[str, List[np.ndarray]]:
    """64-frame L2L window export (vico_preprocessing_l2l.py:171-203).

    Returns the p0_* arrays: listener faces, speaker mel audio (4x rate),
    speaker faces, and file bookkeeping. The last (partial) segment and the
    one before it are dropped like the reference (``range(num_segments-1)``).
    """
    n = min(video_speaker.shape[0], video_listener.shape[0])
    mel = load_melspec_features(waveform, n).transpose(1, 0)  # (4n, n_mels)
    out = {"list_faces": [], "speak_audio": [], "speak_faces": [], "speak_files": []}
    num_segments = video_speaker.shape[0] // num_frames
    for i in range(num_segments - 1):
        v_s = video_speaker[i * num_frames: (i + 1) * num_frames]
        v_l = video_listener[i * num_frames: (i + 1) * num_frames]
        a = mel[i * num_frames * 4: (i + 1) * num_frames * 4]
        if len(v_s) == len(v_l) == num_frames and len(a) == num_frames * 4:
            out["list_faces"].append(v_l)
            out["speak_audio"].append(a)
            out["speak_faces"].append(v_s)
            out["speak_files"].append([[file_id, "0", str(i * num_frames + j)]
                                       for j in range(num_frames)])
    return out


def split_video_lr(video_path: str) -> Tuple[str, str]:
    """Split a side-by-side interview video into left/right halves
    (preprocess_deception.py:12-40). Requires OpenCV."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    left_path = video_path.replace(".mp4", "_left.mp4")
    right_path = video_path.replace(".mp4", "_right.mp4")
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    lw = cv2.VideoWriter(left_path, fourcc, fps, (width // 2, height))
    rw = cv2.VideoWriter(right_path, fourcc, fps, (width // 2, height))
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        lw.write(frame[:, : width // 2])
        rw.write(frame[:, width // 2:])
    for h in (cap, lw, rw):
        h.release()
    return left_path, right_path


def voca_copy_frames(original_root: str, output_root: str,
                     camera_tag: str = "26_C", subjects: Iterable[int] = (8,)) -> int:
    """Copy one camera's frames per sentence (voca_preprocessing.py)."""
    import shutil

    copied = 0
    for i in subjects:
        subj_dir = os.path.join(original_root, f"imagessubject{i}")
        if not os.path.isdir(subj_dir):
            continue
        for folder_id in os.listdir(subj_dir):
            if not folder_id.startswith("FaceTalk"):
                continue
            for sentence_id in os.listdir(os.path.join(subj_dir, folder_id)):
                cur = os.path.join(subj_dir, folder_id, sentence_id)
                out_dir = os.path.join(output_root, f"imagessubject{i}", folder_id,
                                       sentence_id)
                os.makedirs(out_dir, exist_ok=True)
                for frame_id in sorted(f for f in os.listdir(cur) if camera_tag in f):
                    shutil.copy(os.path.join(cur, frame_id), out_dir)
                    copied += 1
    return copied
