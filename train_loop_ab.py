#!/usr/bin/env python3
"""The DINO trainer's data loop on one card: where its time goes and how the
ways of decoding compare.

    python3 train_loop_ab.py [survey] [decode] [bare] [loop] [wsi] [sup]

Modes, in the order given (the first four when none is named):

- ``survey``: which image decoders the machine has (Python packages and the
  shared libraries ``ldconfig -p`` lists, zlib's among them), and the C
  compiler that builds the PNG decoder;
- ``decode``: two seeded folders of the same 2 x 480 tissue-like PNG tiles
  of 256 px: ``chip_smoke.write_ssl_folder``'s (each scanline filtered as
  libpng chooses) and the same pixels saved by PIL with its defaults, where
  PIL imports. For each: the share of each scanline filter, ms per tile
  decoded on the calling thread (``decode_png``, the file in memory), then
  batches of 96 through ``ImageFolderDataset.batches`` on 1, 2, 4 and 8 of
  the C decoder's threads and, for comparison, with ``load_image`` mapped
  over 1, 2, 4 and 8 spawned worker processes (ms per batch, the first batch
  left out); and one batch pinned and copied to the card;
- ``bare``: the DINO step of ``chip_smoke.phase_train`` on a resident batch
  (median of 6 steps after 2), alone, with 1 and with 4 threads decoding
  PNG batches beside it;
- ``loop``: ``tpuwsi_torch.cli.train.main`` over the libpng folder for two
  epochs of 10 steps (no probe), with the batches decoded on the C
  decoder's 4 threads (the loop as it is), the same with
  ``--grad-checkpointing``, in 4 worker processes, and on the
  ``Prefetcher``'s thread alone (``--workers 0``), in the order threads,
  recomputing, processes, one, one, processes, recomputing, threads: the
  median of the 18 gaps between the starts of an epoch's consecutive steps
  (``chip_smoke.loop_timing``), the share of them spent waiting on the data,
  and the peak device memory;
- ``wsi``: the slide paths of ``chip_smoke.py`` (its ``[wsi_cohort]``,
  ``[slice]`` and ``[wsi_ef]`` phases), then the bare step alone, beside
  ``crop_resize`` cutting batches of 96 tiles 512² → 256² from a decoded
  slide on 4 threads (C only, outside the interpreter lock), and beside a
  ``WSITileSampler`` making WSI-mode batches (its Python draws and the same
  C call), and WSI-mode ``main --ssl`` over the cohort's training fold for
  2 epochs of 10 steps, twice: the median of the 18 step gaps, the wait on
  the data and the first step's wait;
- ``sup``: ``chip_smoke.py``'s ``[wsi_cohort]``, then supervised ``main``
  with ``[train_sup]``'s arguments for 3 epochs of 3 steps of 256 tiles,
  with ``-j 4``, ``-j 8`` and ``-j 4`` again: the step's device time (CUDA
  events around it), the gaps between step starts, the wait on the data and
  the peak device memory.

Every line names the card and its power limit. The worker processes are
spawned and import this script: its work stays under the ``__main__``
check.
"""

from __future__ import annotations

import importlib
import multiprocessing
import shutil
import statistics
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from tpuwsi_torch.cli.train import _pinned
from tpuwsi_torch.io import folder, image

BATCH, LOOP_EPOCHS, LOOP_STEPS, TILES_PER_CLASS = 96, 2, 10, 480
DECODERS = ("torchvision", "cv2", "imageio", "PIL", "pandas", "simplejpeg", "turbojpeg",
            "tifffile")
FILTERS = ("None", "Sub", "Up", "Average", "Paeth")


def survey() -> None:
    for name in DECODERS:
        try:
            mod = importlib.import_module(name)
            print(f"[survey] {name}: {getattr(mod, '__version__', 'present')}")
        except ImportError as e:
            print(f"[survey] {name}: not importable ({type(e).__name__})")
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    for line in libs.splitlines():
        if any(k in line.lower() for k in ("jpeg", "tiff", "png", "webp", "openjp", "libz.")):
            print(f"[survey] ldconfig: {line.strip()}")
    for cc in ("cc", "gcc", "clang"):
        print(f"[survey] {cc}: {shutil.which(cc)}")


def process_batches(ds, workers: int, pool: ProcessPoolExecutor):
    """``ds.batches``'s order (seed 0, shuffled, last partial batch dropped)
    with each batch's files decoded in ``pool``'s worker processes."""
    order = np.arange(len(ds))
    np.random.default_rng(0).shuffle(order)
    for start in range(0, len(order) - BATCH + 1, BATCH):
        chunk = [int(i) for i in order[start:start + BATCH]]
        n = len(chunk)
        images = list(pool.map(image.load_image, [ds.samples[i][0] for i in chunk], [3] * n,
                               [None] * n, chunksize=max(1, n // (2 * workers))))
        yield {"images": np.stack(images),
               "labels": np.asarray([ds.samples[i][1] for i in chunk], dtype=np.int64)}


def spawn_pool(workers: int) -> ProcessPoolExecutor:
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    list(pool.map(abs, range(workers)))  # started before anything is timed
    return pool


def ms_per_batch(batches) -> float:
    next(batches)  # the first pays for starting the threads or the library load
    t0, n = time.perf_counter(), 0
    for _ in batches:
        n += 1
    return (time.perf_counter() - t0) / n * 1e3


def filter_shares(ds) -> str:
    """The share of each scanline filter type over the folder's files."""
    counts = np.zeros(5, np.int64)
    for path, _ in ds.samples:
        data, pos, idat = open(path, "rb").read(), 8, []
        height = int.from_bytes(data[20:24], "big")
        while pos < len(data):
            length = int.from_bytes(data[pos:pos + 4], "big")
            if data[pos + 4:pos + 8] == b"IDAT":
                idat.append(data[pos + 8:pos + 8 + length])
            pos += 12 + length
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        counts += np.bincount(raw.reshape(height, -1)[:, 0], minlength=5)
    return ", ".join(f"{name} {100 * n / counts.sum():.1f}%" for name, n in zip(FILTERS, counts))


def pil_folder():
    """The libpng folder's pixels saved again by PIL with its defaults, or
    None where PIL does not import."""
    try:
        from PIL import Image
    except ImportError:
        print("[decode] PIL does not import: no PIL-written folder")
        return None
    root = cs.OUT / "ssl_folder_ab_pil"
    for path, _ in folder.ImageFolderDataset(str(cs.SSL_DIR)).samples:
        out = root / path.split("/")[-2] / path.split("/")[-1]
        out.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(image.decode_png(path)).save(out, "PNG")
    return root


def decode(smi: str) -> None:
    rng = np.random.default_rng
    roots = [("libpng", cs.SSL_DIR)]
    pil_root = pil_folder()
    if pil_root is not None:
        roots.append(("PIL", pil_root))
    for tag, root in roots:
        ds = folder.ImageFolderDataset(str(root))
        print(f"[decode] {tag} folder: scanline filters {filter_shares(ds)}", flush=True)
        datas = [open(p, "rb").read() for p, _ in ds.samples[:200]]
        image.decode_png(ds.samples[0][0])  # builds or loads the decoding library
        t0 = time.perf_counter()
        for p, data in zip(ds.samples, datas):
            image.decode_png(p[0], data)
        per_tile = (time.perf_counter() - t0) / len(datas) * 1e3
        print(f"[decode] {tag}: {per_tile:.3f} ms a tile on the calling thread (file in memory); "
              f"on {smi}")
        for n in (1, 2, 4, 8):
            ms = ms_per_batch(ds.batches(BATCH, rng=rng(0), workers=n))
            print(f"[decode] {tag}: {n} threads {ms:.2f} ms a batch of {BATCH}; on {smi}",
                  flush=True)
        for n in (1, 2, 4, 8):
            pool = spawn_pool(n)
            ms = ms_per_batch(process_batches(ds, n, pool))
            pool.shutdown()
            print(f"[decode] {tag}: {n} worker processes {ms:.2f} ms a batch; on {smi}",
                  flush=True)
    batch = next(folder.ImageFolderDataset(str(cs.SSL_DIR)).batches(BATCH, rng=rng(0)))
    pin, copy = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        pinned = next(_pinned(iter([batch])))
        pin.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned["images"].to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t0) * 1e3)
    print(f"[decode] pin {statistics.median(pin):.2f} ms, H2D {statistics.median(copy):.2f} "
          f"ms for {batch['images'].nbytes / 2**20:.1f} MiB; on {smi}")


def bare(smi: str) -> float:
    bundle, batch = cs.train_bundle(), cs.train_batch()
    rows = cs.run_steps(bundle, batch, cs.WARMUP_STEPS + cs.TIMED_STEPS)
    alone = statistics.median(r["ms"] for r in rows[cs.WARMUP_STEPS:])
    ds, beside = folder.ImageFolderDataset(str(cs.SSL_DIR)), {}
    for threads in (1, 4):
        stop = threading.Event()

        def decode_forever():
            while not stop.is_set():
                for _ in ds.batches(BATCH, rng=np.random.default_rng(0), workers=threads):
                    if stop.is_set():
                        return

        decoder = threading.Thread(target=decode_forever, daemon=True)
        decoder.start()
        time.sleep(0.5)
        rows = cs.run_steps(bundle, batch, cs.WARMUP_STEPS + cs.TIMED_STEPS)
        beside[threads] = statistics.median(r["ms"] for r in rows[cs.WARMUP_STEPS:])
        stop.set()
        decoder.join(timeout=60)
    print(f"[bare] the step {alone:.2f} ms alone, {beside[1]:.2f} ms with 1 thread and "
          f"{beside[4]:.2f} ms with 4 threads decoding PNG batches beside it; on {smi}")
    del bundle
    torch.cuda.empty_cache()
    return alone


def loop(smi: str) -> None:
    cs.SSL_EPOCHS, cs.SSL_STEPS = LOOP_EPOCHS, LOOP_STEPS
    argv = list(cs.SSL_ARGV)
    for flag, value in (("--epochs", str(LOOP_EPOCHS)), ("--max-steps-per-epoch", str(LOOP_STEPS)),
                        ("--knn-eval-rate", "0")):
        argv[argv.index(flag) + 1] = value
    cs.SSL_ARGV = argv
    real_batches = folder.ImageFolderDataset.batches
    pool = spawn_pool(4)

    def in_processes(self, batch_size, rng=None, workers=0, **kw):
        return process_batches(self, 4, pool)

    results = {}
    for tag, how in (("t1", "threads"), ("r1", "threads, recomputing"), ("p1", "processes"),
                     ("o1", "one thread"), ("o2", "one thread"), ("p2", "processes"),
                     ("r2", "threads, recomputing"), ("t2", "threads")):
        extra = {"one thread": ["--workers", "0"],
                 "threads, recomputing": ["--grad-checkpointing"]}.get(how, [])
        if how == "processes":
            folder.ImageFolderDataset.batches = in_processes
        try:
            run = cs.ssl_run(cs.SSL_RUNS / tag,
                             cs.SSL_ARGV + ["--data-dir", str(cs.SSL_DIR)] + extra)
        finally:
            folder.ImageFolderDataset.batches = real_batches
        gaps, wait = cs.loop_timing(run)
        results.setdefault(how, []).append(statistics.median(gaps))
        print(f"[loop] {tag} ({how}): median of {len(gaps)} step gaps "
              f"{statistics.median(gaps):.2f} ms, each {[round(g, 2) for g in gaps]}; waiting "
              f"on the data {100 * wait:.1f}%; the first step waited "
              f"{run['rows'][0]['wait']:.2f} s; peak device memory "
              f"{run['peak'] / 2**30:.2f} GiB; on {smi}", flush=True)
        shutil.rmtree(run["out"], ignore_errors=True)  # its checkpoints, ~0.66 GB each
        del run
        torch.cuda.empty_cache()
    pool.shutdown()
    print(f"[loop] medians by way of decoding: {results}; the bare step "
          f"{cs.STEP_MS['tuned']:.2f} ms; on {smi}")


def beside(smi: str, bundle, batch, arms: dict) -> dict:
    """The bare step's median ms with each arm's work running on a thread
    beside it (None: alone)."""
    out = {}
    for name, work in arms.items():
        stop = threading.Event()
        worker = None
        if work is not None:
            def run(work=work):
                while not stop.is_set():
                    work(stop)

            worker = threading.Thread(target=run, daemon=True)
            worker.start()
            time.sleep(0.5)
        rows = cs.run_steps(bundle, batch, cs.WARMUP_STEPS + cs.TIMED_STEPS)
        out[name] = statistics.median(r["ms"] for r in rows[cs.WARMUP_STEPS:])
        stop.set()
        if worker is not None:
            worker.join(timeout=60)
    return out


def wsi(smi: str) -> None:
    from tpuwsi_torch.cli.train import ssl_slide_table
    from tpuwsi_torch.io.wsi import WSITileSampler

    cs.phase_slice(smi)
    cs.phase_wsi_cohort(smi)
    cs.phase_wsi_ef(smi)
    args = cs.parse_args(cs.WSI_SSL_ARGV)
    sampler = WSITileSampler(ssl_slide_table(args), n_tiles=cs.WSI_SSL_TILES, num_threads=4)
    arr = image.decode_png(sampler.table.slide_path(0))
    boxes = np.asarray([(r, c, 512, 512, 512) for r, c in np.random.default_rng(0).integers(
        0, cs.WSI_SIZE - 512, (BATCH, 2))], np.int32)

    def cut(stop):
        image.crop_resize([arr] * BATCH, boxes, cs.WSI_TILE, threads=4)

    def sample(stop):
        for _ in sampler.batches(np.random.default_rng(0), BATCH):
            if stop.is_set():
                return

    bundle, batch = cs.train_bundle(), cs.train_batch()
    ms = beside(smi, bundle, batch, {"alone": None, "cut": cut, "sampler": sample,
                                     "alone ": None})
    cs.STEP_MS["tuned"] = ms["alone"]
    print(f"[wsi] the bare step {ms['alone']:.2f} / {ms['alone ']:.2f} ms alone, "
          f"{ms['cut']:.2f} ms beside crop_resize on 4 threads (96 tiles 512 -> 256 a call), "
          f"{ms['sampler']:.2f} ms beside the WSITileSampler making batches of 96; on {smi}",
          flush=True)
    sampler.close()
    del bundle, batch, arr
    torch.cuda.empty_cache()
    argv = list(cs.WSI_SSL_ARGV)
    argv[argv.index("--epochs") + 1] = str(LOOP_EPOCHS)
    for tag in ("w1", "w2"):
        run = cs.ssl_run(cs.WSI_RUNS / tag, argv)
        gaps, wait = cs.loop_timing(run, LOOP_EPOCHS, LOOP_STEPS)
        print(f"[wsi] loop {tag}: median of {len(gaps)} step gaps {statistics.median(gaps):.2f} "
              f"ms, each {[round(g, 2) for g in gaps]}; waiting on the data {100 * wait:.1f}%; "
              f"the first step waited {run['rows'][0]['wait']:.2f} s; peak device memory "
              f"{run['peak'] / 2**30:.2f} GiB; the bare step {ms['alone']:.2f} ms; on {smi}",
              flush=True)
        shutil.rmtree(cs.WSI_RUNS, ignore_errors=True)
        del run
        torch.cuda.empty_cache()
    shutil.rmtree(cs.WSI_ROOT, ignore_errors=True)


def sup(smi: str) -> None:
    cs.phase_wsi_cohort(smi)
    for workers in ("4", "8", "4"):
        argv = cs.SUP_ARGV + ["--epochs", "3", "-j", workers]
        run = cs.sup_run(cs.SUP_RUNS / f"j{workers}", argv)
        gaps, wait = cs.loop_timing(run, 3, 3)
        dev = [r["ms"] for r in run["rows"][1:]]
        print(f"[sup] -j {workers}: the step's stream time {[round(d, 2) for d in dev]} ms "
              f"(median {statistics.median(dev):.2f}); gaps {[round(g, 2) for g in gaps]} ms "
              f"(median {statistics.median(gaps):.2f}, epochs 2-3 "
              f"{statistics.median(gaps[2:]):.2f}); waiting {100 * wait:.1f}%; peak "
              f"{run['peak'] / 2**30:.2f} GiB; main() {run['wall']:.2f} s; on {smi}", flush=True)
        del run
        shutil.rmtree(cs.SUP_RUNS, ignore_errors=True)
        torch.cuda.empty_cache()
    shutil.rmtree(cs.WSI_ROOT, ignore_errors=True)


def main() -> None:
    modes = sys.argv[1:] or ["survey", "decode", "bare", "loop"]
    smi = cs.phase_device()
    if "survey" in modes:
        survey()
    if {"decode", "bare", "loop"} & set(modes):
        cs.SSL_PER_CLASS, cs.SSL_DIR = TILES_PER_CLASS, cs.OUT / "ssl_folder_ab"
        cs.SSL_RUNS = cs.OUT / "train_loop_ab"
        cs.write_ssl_folder()
    if "decode" in modes:
        decode(smi)
    if "bare" in modes or "loop" in modes:
        cs.phase_build()
        cs.STEP_MS["tuned"] = bare(smi)
    if "loop" in modes:
        loop(smi)
    if "wsi" in modes or "sup" in modes:
        if "bare" not in modes and "loop" not in modes:
            cs.phase_build()
    if "wsi" in modes:
        wsi(smi)
    if "sup" in modes:
        sup(smi)


if __name__ == "__main__":
    main()
