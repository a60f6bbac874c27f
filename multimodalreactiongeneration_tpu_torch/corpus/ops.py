"""Corpus normalization CLI ops (reference data/ scripts).

A copy of ``multimodalreactiongeneration_tpu/corpus/ops.py`` on the
port's head and wav IO. One module, one function per reference script:
  * rename_sessions        == data/rename.py:26-109 (movie.mp4 / comp.wav /
    host.wav / pair.wav normalization + participant.json bookkeeping)
  * collect_participant_info == data/collect_participant_info.py:17-64
  * make_stereo            == data/stereo_wav_maker.py:29-114 (interleave
    comp/host mono into a stereo annotation wav, copy movie)
  * check_audio            == utils/data_analysis/check_audio.py:113-153
    (1ch / 16-bit / 16 kHz validation walk)
  * extract_good_sessions  == utils/data_analysis/data_extractor.py:52-86
  * anomaly_search         == data/anomaly_search.py:19-29 (count None
    FaceMesh frames per head dir -> JSONL report)
  * compute_head_statistics == utils/io.py:88-118 + utils/visualize/
    calc_dataset_statistics.py:10-41 (corpus mean/std of angle/centroid)
  * stamp_statistics       == scripts/patch/patch_for_statis.py (write the
    corpus stats back into every .head frame)
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.data.head_io import (
    ZERO_PADDING,
    load_head_file,
    loads_head,
    write_head_frame,
)
from multimodalreactiongeneration_tpu_torch.utils.wavio import (
    read_wav,
    wav_info,
    write_wav,
)


def _ex_name(file: str) -> str:
    person = file.rsplit(".", maxsplit=1)[0]
    return "_".join(person.split("_", maxsplit=1)[1:])


def rename_sessions(target: str) -> Dict[str, int]:
    """Normalize raw session layouts; returns the participant table."""
    person_info: Dict[str, int] = {}
    rename_list: List[Tuple[str, str]] = []
    for dirc in sorted(os.listdir(target)):
        target_dirc = os.path.join(target, dirc)
        if not os.path.isdir(target_dirc):
            continue
        session_info = {"host": None, "comp": None, "host_no": None, "comp_no": None}
        for file in os.listdir(target_dirc):
            src = os.path.join(target_dirc, file)
            if file.startswith("movie"):
                sub = "movie.mp4"
            elif file.startswith("c-"):
                sub = "comp.wav"
                session_info["comp"] = _ex_name(file)
            elif file.startswith("h-"):
                sub = "host.wav"
                session_info["host"] = _ex_name(file)
            elif file.startswith("pair"):
                sub = "pair.wav"
            else:
                continue
            rename_list.append((src, os.path.join(target_dirc, sub)))

        for who in ("host", "comp"):
            name = session_info[who]
            if person_info.get(name) is None:
                person_info[name] = len(person_info)
            session_info[f"{who}_no"] = person_info[name]
        with open(
            os.path.join(target_dirc, "participant.json"), "w", encoding="utf-8"
        ) as f:
            f.write(json.dumps(session_info, ensure_ascii=False))
    with open(
        os.path.join(target, "all_participant.json"), "w", encoding="utf-8"
    ) as f:
        f.write(json.dumps(person_info, ensure_ascii=False))
    for src, dst in rename_list:
        os.rename(src, dst)
    return person_info


def collect_participant_info(target: str) -> Dict[str, Dict]:
    """Aggregate participant appearance counts across sessions."""
    table: Dict[str, Dict] = {}
    for dirc in sorted(os.listdir(target)):
        info_path = os.path.join(target, dirc, "participant.json")
        if not os.path.isfile(info_path):
            continue
        with open(info_path, "r", encoding="utf-8") as f:
            info = json.load(f)
        for who in ("host", "comp"):
            name = info.get(who)
            if name is None:
                continue
            entry = table.setdefault(
                name, {"no": info.get(f"{who}_no"), "host": 0, "comp": 0}
            )
            entry[who] += 1
    out = os.path.join(target, "participant_summary.json")
    with open(out, "w", encoding="utf-8") as f:
        f.write(json.dumps(table, ensure_ascii=False, indent=2))
    return table


def make_stereo(session_dir: str, output_dir: str) -> str:
    """comp.wav + host.wav -> stereo pair_stereo.wav (+ movie copy)."""
    os.makedirs(output_dir, exist_ok=True)
    comp, sr_c = read_wav(os.path.join(session_dir, "comp.wav"))
    host, sr_h = read_wav(os.path.join(session_dir, "host.wav"))
    if sr_c != sr_h:
        raise ValueError("comp/host sample rates differ")
    n = min(comp.shape[1], host.shape[1])
    stereo = np.stack([comp[0, :n], host[0, :n]], axis=0)
    out = os.path.join(output_dir, "pair_stereo.wav")
    write_wav(out, stereo, sr_c)
    movie = os.path.join(session_dir, "movie.mp4")
    if os.path.exists(movie):
        shutil.copy(movie, os.path.join(output_dir, "movie.mp4"))
    return out


def check_audio(
    root: str, sample_rate: int = 16000
) -> Dict[str, List[str]]:
    """Validate every wav: mono / 16-bit / expected rate."""
    result = {"ok": [], "bad": []}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".wav"):
                continue
            path = os.path.join(dirpath, name)
            try:
                sr, _, nch = wav_info(path)
                good = sr == sample_rate and nch == 1
            except Exception:
                good = False
            result["ok" if good else "bad"].append(path)
    return result


def extract_good_sessions(
    src_root: str, dst_root: str, sample_rate: int = 16000
) -> List[str]:
    """Copy corpus, dropping sessions with invalid audio."""
    os.makedirs(dst_root, exist_ok=True)
    kept = []
    for session in sorted(os.listdir(src_root)):
        sdir = os.path.join(src_root, session)
        if not os.path.isdir(sdir):
            continue
        report = check_audio(sdir, sample_rate)
        if report["bad"] or not report["ok"]:
            continue
        shutil.copytree(sdir, os.path.join(dst_root, session))
        kept.append(session)
    return kept


def anomaly_search(root: str, result_path: str) -> None:
    """Per head-dir undetected-frame report (JSONL)."""
    if os.path.isfile(result_path):
        os.remove(result_path)
    with open(result_path, "a", encoding="utf-8") as out:
        for dirpath, _, files in os.walk(root):
            heads = sorted(f for f in files if f.endswith(".head"))
            if not heads:
                continue
            jdic = {"path": dirpath, "count": 0, "anomaly": []}
            for name in heads:
                idx, frame = load_head_file(os.path.join(dirpath, name))
                if frame is None:
                    jdic["count"] += 1
                    jdic["anomaly"].append(idx)
            out.write(json.dumps(jdic, ensure_ascii=False) + "\n")


def angle_jump_statistics(
    root: str, threshold: float = 8.0, hist_dir: str | None = None
):
    """Frame-to-frame angle-jump statistics per head dir.

    Capability equivalent of the reference's exploratory
    calc_delta_statistics script (scripts/calc_delta_statistics.py:23-55):
    for every directory of per-frame ``.head`` pickles, stack the angles
    of detected frames in index order, compute the Euclidean norm of
    consecutive differences, and report mean/std plus the frame indices
    whose jump exceeds ``threshold`` degrees (FaceMesh glitch detector).
    With ``hist_dir`` set, a 50-bin histogram PNG is saved per dir.
    Yields one record per head dir.
    """
    for dirpath, _, files in os.walk(root):
        heads = sorted(f for f in files if f.endswith(".head"))
        if not heads:
            continue
        angles, indices = [], []
        for name in heads:
            idx, frame = load_head_file(os.path.join(dirpath, name))
            if frame is not None:
                angles.append(frame.angle)
                indices.append(idx)
        if len(angles) < 2:
            continue
        dist = np.linalg.norm(np.diff(np.stack(angles), axis=0), axis=1)
        jumps = [
            {"frame": int(indices[i + 1]), "jump_deg": float(d)}
            for i, d in enumerate(dist)
            if d > threshold
        ]
        if hist_dir:
            import matplotlib

            matplotlib.use("Agg")
            from matplotlib import pyplot as plt

            os.makedirs(hist_dir, exist_ok=True)
            plt.hist(dist, bins=50)
            plt.xlabel("|d angle| per frame (deg)")
            # name by the root-relative path: a bare basename collides
            # across sessions (every session has a comp/ and a host/)
            rel = os.path.relpath(dirpath, root).replace(os.sep, "_")
            name = rel if rel != "." else "root"
            plt.savefig(os.path.join(hist_dir, f"{name}_angle_jumps.png"))
            plt.clf()
        yield {
            "path": dirpath,
            "frames": len(angles),
            "jump_mean": float(dist.mean()),
            "jump_std": float(dist.std()),
            "outliers": jumps,
        }


def compute_head_statistics(head_dir: str):
    """Mean/std of angle & centroid over detected frames (io.py:88-118)."""
    angles, cents = [], []
    for name in sorted(os.listdir(head_dir)):
        if not name.endswith(".head"):
            continue
        _, frame = load_head_file(os.path.join(head_dir, name))
        if frame is None:
            continue
        angles.append(frame.angle)
        cents.append(frame.centroid)
    if not angles:
        raise ValueError(f"{head_dir}: no detected frames")
    angles = np.stack(angles)
    cents = np.stack(cents)
    return (
        angles.mean(0),
        angles.std(0),
        cents.mean(0),
        cents.std(0),
    )


def stamp_statistics(head_dir: str) -> None:
    """Write corpus stats back into every frame (patch_for_statis.py)."""
    a_mean, a_std, c_mean, c_std = compute_head_statistics(head_dir)
    for name in sorted(os.listdir(head_dir)):
        if not name.endswith(".head"):
            continue
        path = os.path.join(head_dir, name)
        idx, frame = load_head_file(path)
        if frame is None:
            continue
        frame.angle_mean, frame.angle_std = a_mean, a_std
        frame.centroid_mean, frame.centroid_std = c_mean, c_std
        write_head_frame(path, idx, frame)


def quarantine_sessions(
    root: str,
    anomaly_report: str,
    quarantine_dir: str,
    max_misses: int = 400,
) -> List[str]:
    """Move sessions whose head dirs exceed max_misses undetected frames
    (reference data/remove_anomaly.sh:1-40, threshold 400)."""
    os.makedirs(quarantine_dir, exist_ok=True)
    moved = []
    with open(anomaly_report, "r", encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec["count"] <= max_misses:
                continue
            session = os.path.dirname(rec["path"])
            # skip anything outside root OR not a directory: `or`, not
            # `and` — the old `and` let an existing dir outside root
            # through to shutil.move
            if not session.startswith(os.path.abspath(root)) or not os.path.isdir(
                session
            ):
                continue
            dst = os.path.join(quarantine_dir, os.path.basename(session))
            if os.path.isdir(session) and not os.path.exists(dst):
                shutil.move(session, dst)
                moved.append(session)
    return moved


def backfill_missing_frames(head_dir: str) -> int:
    """Write (idx, None) placeholder files for gaps in the frame index
    sequence (reference patch_for_statis_fix.py:14-25)."""
    idxs = sorted(
        int(f.rsplit("_", 1)[1].split(".")[0])
        for f in os.listdir(head_dir)
        if f.endswith(".head")
    )
    if not idxs:
        return 0
    base = os.path.split(head_dir)[1]
    written = 0
    for i in range(idxs[0], idxs[-1] + 1):
        path = os.path.join(head_dir, f"{base}_{str(i).zfill(5)}.head")
        if not os.path.exists(path):
            write_head_frame(path, i, None)
            written += 1
    return written


def duration_anomaly(root: str, fps: float = 25.0, tolerance: float = 1.0):
    """Audio-duration vs head-frame-count invariant check (reference
    scripts/patch duration_anomaly): flags sessions where the wav length
    and the number of estimated frames disagree by > tolerance seconds."""
    report = []
    for dirpath, dirs, files in os.walk(root):
        heads = [f for f in files if f.endswith(".head")]
        if not heads:
            continue
        session = os.path.dirname(dirpath)
        who = os.path.basename(dirpath)
        wav = os.path.join(session, who + ".wav")
        if not os.path.exists(wav):
            continue
        sr, frames, _ = wav_info(wav)
        audio_sec = frames / sr
        head_sec = len(heads) / fps
        if abs(audio_sec - head_sec) > tolerance:
            report.append(
                {
                    "dir": dirpath,
                    "audio_sec": round(audio_sec, 2),
                    "head_sec": round(head_sec, 2),
                }
            )
    return report


def migrate_split_head(target: str, output: str) -> int:
    """Reference scripts/patch/patch_for_save.py:1-44: split MONOLITHIC
    ``.head`` pickles (one list of frames per recording — the
    pre-per-frame-era format) into the per-frame ``(idx, frame)`` pickle
    directories the production loaders read, copying wavs alongside.
    ``None`` frames are preserved (the reference dumps every entry).
    Returns the number of frame files written."""
    n = 0
    for dirpath, _dirs, files in os.walk(target):
        rel = os.path.relpath(dirpath, target)
        outdir = os.path.normpath(os.path.join(output, rel))
        for fname in sorted(files):
            src = os.path.join(dirpath, fname)
            if fname.endswith(".wav"):
                os.makedirs(outdir, exist_ok=True)
                shutil.copy2(src, os.path.join(outdir, fname))
                continue
            if not fname.endswith(".head"):
                continue
            base = fname.rsplit(".", 1)[0]
            head_dir = os.path.join(outdir, base)
            os.makedirs(head_dir, exist_ok=True)
            with open(src, "rb") as f:
                frames = loads_head(f.read())
            for i, frame in enumerate(frames):
                out = os.path.join(
                    head_dir,
                    f"{base}_{str(i).zfill(ZERO_PADDING)}.head",
                )
                write_head_frame(out, i, frame)
                n += 1
    return n


def migrate_stamp_fps(target: str, output: str, fps: float = 25.0) -> int:
    """Reference scripts/patch/patch_for_faceadpter.py:1-30: re-stamp
    ``time``/``frame_no``/``fps`` on every frame of monolithic ``.head``
    pickles, DROPPING undetected (None) frames like the reference, and
    write the repaired monolithic file to the mirrored output tree.
    Returns the number of files migrated."""
    import pickle

    n = 0
    for dirpath, _dirs, files in os.walk(target):
        rel = os.path.relpath(dirpath, target)
        outdir = os.path.normpath(os.path.join(output, rel))
        for fname in sorted(files):
            if not fname.endswith(".head"):
                continue
            with open(os.path.join(dirpath, fname), "rb") as f:
                frames = loads_head(f.read())
            kept = []
            for i, frame in enumerate(frames):
                if frame is None:
                    continue
                frame.time = i / fps
                frame.frame_no = i
                frame.fps = fps
                kept.append(frame)
            os.makedirs(outdir, exist_ok=True)
            with open(os.path.join(outdir, fname), "wb") as f:
                pickle.dump(kept, f)
            n += 1
    return n


def migrate_copy_wavs(target: str, output: str) -> int:
    """Reference scripts/patch/patch_for_wav.py:1-18: mirror the
    host/comp wavs from one corpus tree into another (skip existing).
    Returns the number of files copied."""
    n = 0
    for dirpath, _dirs, files in os.walk(target):
        rel = os.path.relpath(dirpath, target)
        outdir = os.path.normpath(os.path.join(output, rel))
        for fname in sorted(files):
            if not fname.endswith(".wav"):
                continue
            if "host" not in fname and "comp" not in fname:
                continue
            dst = os.path.join(outdir, fname)
            if os.path.isfile(dst):
                continue
            os.makedirs(outdir, exist_ok=True)
            shutil.copy(os.path.join(dirpath, fname), dst)
            n += 1
    return n


def main(argv=None):
    """python -m multimodalreactiongeneration_tpu_torch.corpus.ops
    <subcommand> --target <dir> [...] [--device cpu]

    The ops are host file work; every subcommand takes ``--device`` as
    every entry point of the port does (the card unless it names one) and
    raises without CUDA when it names none."""
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="the port's device (default cuda:0)")
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    add = functools.partial(sub.add_parser, parents=[common])

    p = add("rename")
    p.add_argument("--target", required=True)
    p = add("participants")
    p.add_argument("--target", required=True)
    p = add("stereo")
    p.add_argument("--target", required=True)
    p.add_argument("--output", required=True)
    p = add("check-audio")
    p.add_argument("--target", required=True)
    p.add_argument("--sample-rate", type=int, default=16000)
    p = add("extract")
    p.add_argument("--target", required=True)
    p.add_argument("--output", required=True)
    p = add("anomaly")
    p.add_argument("--target", required=True)
    p.add_argument("--output", default="anomaly_search_result.json")
    p = add("statistics")
    p.add_argument("--target", required=True)
    p.add_argument("--stamp", action="store_true")
    p = add("duration-check")
    p.add_argument("--target", required=True)
    p.add_argument("--fps", type=float, default=25.0)
    p = add("quarantine")
    p.add_argument("--target", required=True)
    p.add_argument("--report", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-misses", type=int, default=400)
    p = add("backfill")
    p.add_argument("--target", required=True)
    p = add("angle-jumps")
    p.add_argument("--target", required=True)
    p.add_argument("--threshold", type=float, default=8.0)
    p.add_argument("--hist-dir", default=None)
    p = add("migrate-split-head")
    p.add_argument("--target", required=True)
    p.add_argument("--output", required=True)
    p = add("migrate-stamp-fps")
    p.add_argument("--target", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--fps", type=float, default=25.0)
    p = add("migrate-copy-wavs")
    p.add_argument("--target", required=True)
    p.add_argument("--output", required=True)

    args = parser.parse_args(argv)
    resolve_device(args.device)
    if args.cmd == "rename":
        rename_sessions(args.target)
    elif args.cmd == "participants":
        collect_participant_info(args.target)
    elif args.cmd == "stereo":
        for session in sorted(os.listdir(args.target)):
            sdir = os.path.join(args.target, session)
            if os.path.isdir(sdir):
                make_stereo(sdir, os.path.join(args.output, session))
    elif args.cmd == "check-audio":
        report = check_audio(args.target, args.sample_rate)
        print(json.dumps({k: len(v) for k, v in report.items()}))
        for path in report["bad"]:
            print("BAD:", path)
    elif args.cmd == "extract":
        kept = extract_good_sessions(args.target, args.output)
        print(f"kept {len(kept)} sessions")
    elif args.cmd == "anomaly":
        anomaly_search(args.target, args.output)
    elif args.cmd == "statistics":
        for dirpath, dirs, files in os.walk(args.target):
            if any(f.endswith(".head") for f in files):
                stats = compute_head_statistics(dirpath)
                print(dirpath, [np.round(s, 4).tolist() for s in stats])
                if args.stamp:
                    stamp_statistics(dirpath)
    elif args.cmd == "duration-check":
        for rec in duration_anomaly(args.target, args.fps):
            print(json.dumps(rec))
    elif args.cmd == "quarantine":
        moved = quarantine_sessions(
            args.target, args.report, args.output, args.max_misses
        )
        print(f"quarantined {len(moved)} sessions")
    elif args.cmd == "angle-jumps":
        for rec in angle_jump_statistics(
            args.target, args.threshold, args.hist_dir
        ):
            print(json.dumps(rec))
    elif args.cmd == "backfill":
        for dirpath, _, files in os.walk(args.target):
            if any(f.endswith(".head") for f in files):
                n = backfill_missing_frames(dirpath)
                if n:
                    print(f"{dirpath}: backfilled {n} placeholders")
    elif args.cmd == "migrate-split-head":
        n = migrate_split_head(args.target, args.output)
        print(f"wrote {n} per-frame files")
    elif args.cmd == "migrate-stamp-fps":
        n = migrate_stamp_fps(args.target, args.output, args.fps)
        print(f"migrated {n} head files")
    elif args.cmd == "migrate-copy-wavs":
        n = migrate_copy_wavs(args.target, args.output)
        print(f"copied {n} wavs")


if __name__ == "__main__":
    main()
