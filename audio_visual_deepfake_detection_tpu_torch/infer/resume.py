"""Shard resume bookkeeping for the inference CLI's ``--resume`` (JAX
``infer/resume.py``).

The flushes are the source of truth: a stopped shard restarts from whatever
``data*.json`` files its output folder holds.

With several hosts, each takes its strided share of the shard first and only
then drops its own already-flushed videos. Filtering the global list and
striding afterwards would move videos between hosts: some would be done by
two hosts and others by none.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Set, Tuple


def flush_files(out_folder: str) -> List[str]:
    """The folder's data*.json flushes in the order they were written:
    numbered flushes by their video count (a lexicographic sort would put
    data_left10000 before data_left5000), then renumbered parts, then the
    unnumbered final flush."""

    def key(path):
        name = os.path.basename(path)
        m = re.fullmatch(r"data_left(\d+)\.json", name)
        if m:
            return (0, int(m.group(1)), name)
        m = re.fullmatch(r"data_left_part(\d+)\.json", name)
        if m:
            return (1, int(m.group(1)), name)
        return (2, 0, name)

    return sorted(glob.glob(os.path.join(out_folder, "data*.json")), key=key)


def atomic_write_json(path: str, payload) -> None:
    """Write through a temporary file and a rename, so that a kill in the
    middle never leaves a truncated JSON behind (os.replace is atomic)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, ensure_ascii=False, indent=4)
    os.replace(tmp, path)


def collect_done(out_folder: str) -> Set[str]:
    """Video ids already in the folder's data*.json flushes. Also renumbers
    a final flush (``data_left.json``) left by an earlier run, so that the
    resumed run's own final flush cannot overwrite it."""
    done: Set[str] = set()
    for path in flush_files(out_folder):
        with open(path, encoding="utf-8") as f:
            for item in json.load(f):
                done.add(item["video_id"])
    final = os.path.join(out_folder, "data_left.json")
    if os.path.exists(final):
        part = 0
        while os.path.exists(os.path.join(out_folder, f"data_left_part{part}.json")):
            part += 1
        os.rename(final, os.path.join(out_folder, f"data_left_part{part}.json"))
    return done


def plan_host_share(data_list: List[Dict], rank: int, nprocs: int,
                    out_folder: str, resume: bool) -> Tuple[List[Dict], Set[str]]:
    """This host's work list: its strided share of the shard, less (when
    resuming) the videos its own folder already flushed. Returns
    (work_list, done_ids). The stride is the loader's unshuffled one
    (``DataLoader._shard_order``), so a host gets the same videos in the
    first run and in a resumed one."""
    share = data_list[rank::nprocs] if nprocs > 1 else list(data_list)
    done: Set[str] = set()
    if resume:
        done = collect_done(out_folder)
        if done:
            share = [it for it in share if it["id"] not in done]
    return share, done
