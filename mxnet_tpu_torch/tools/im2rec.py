"""im2rec: build RecordIO image datasets (counterpart of the repo tool
``tools/im2rec.py``, with the same CLI):

    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list [--recursive]
    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--quality 95 ...]

1. ``--list``: walk an image directory, assign integer labels per
   subdirectory (or read an existing .lst), optionally shuffle/split into
   train/val chunks, and write ``prefix.lst`` tab-separated lines
   ``index\tlabel[\tlabel...]\tpath``.
2. default: read ``prefix.lst``, JPEG-encode (optionally resized/recompressed)
   each image with a worker pool, and append ``prefix.rec`` + ``prefix.idx``
   through MXIndexedRecordIO, the container ``io.ImageRecordIter`` reads.

On the same image tree its list and .rec/.idx files are byte for byte the
repo tool's (same shuffle seed, same PIL encoder, same record format).
"""
from __future__ import annotations

import argparse
import os
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(root, recursive):
    cat = {}
    if recursive:
        for path in sorted(os.listdir(root)):
            full = os.path.join(root, path)
            if not os.path.isdir(full):
                continue
            if path not in cat:
                cat[path] = len(cat)
            for dirpath, _, files in os.walk(full):
                for f in sorted(files):
                    if f.lower().endswith(_EXTS):
                        yield os.path.relpath(os.path.join(dirpath, f),
                                              root), cat[path]
    else:
        for f in sorted(os.listdir(root)):
            if f.lower().endswith(_EXTS):
                yield f, 0


def write_list(args):
    entries = [(p, lab) for p, lab in list_images(args.root, args.recursive)]
    if args.shuffle:
        random.seed(100)
        random.shuffle(entries)
    n = len(entries)
    n_train = int(n * args.train_ratio)
    chunks = [("", entries[:n_train])]
    if args.train_ratio < 1.0:
        chunks = [("_train", entries[:n_train]), ("_val", entries[n_train:])]
        if args.train_ratio == 0.0:
            chunks = [("", entries)]
    for suffix, chunk in chunks:
        path = args.prefix + suffix + ".lst"
        with open(path, "w") as f:
            for i, (p, lab) in enumerate(chunk):
                f.write(f"{i}\t{float(lab)}\t{p}\n")
        print(f"wrote {len(chunk)} entries to {path}")


def read_list(path):
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            yield idx, labels, parts[-1]


def _encode_one(item, root, args):
    """Returns (idx, packed_record_bytes) or (idx, None) on failure."""
    import numpy as np
    from PIL import Image

    from ..io.recordio import IRHeader, pack, pack_img

    idx, labels, path = item
    full = os.path.join(root, path)
    header = IRHeader(0 if len(labels) == 1 else len(labels),
                      labels[0] if len(labels) == 1 else
                      np.asarray(labels, np.float32), idx, 0)
    try:
        if args.pass_through:
            with open(full, "rb") as f:
                return idx, pack(header, f.read())
        img = Image.open(full).convert("RGB")
        if args.resize > 0:
            w, h = img.size
            if min(w, h) > args.resize:
                if w < h:
                    nw, nh = args.resize, int(h * args.resize / w)
                else:
                    nw, nh = int(w * args.resize / h), args.resize
                img = img.resize((nw, nh), Image.BILINEAR)
        if args.center_crop:
            w, h = img.size
            c = min(w, h)
            img = img.crop(((w - c) // 2, (h - c) // 2,
                            (w - c) // 2 + c, (h - c) // 2 + c))
        arr = np.asarray(img, np.uint8)
        return idx, pack_img(header, arr, quality=args.quality,
                             img_fmt=args.encoding)
    except Exception as e:  # counted, like the reference
        print(f"fail to encode {path}: {e}", file=sys.stderr)
        return idx, None


def make_rec(args):
    from ..io.recordio import MXIndexedRecordIO

    lst = args.prefix + ".lst"
    if not os.path.exists(lst):
        raise SystemExit(f"{lst} not found — run with --list first")
    items = list(read_list(lst))
    rec = MXIndexedRecordIO(args.prefix + ".idx", args.prefix + ".rec", "w")
    t0 = time.time()
    done = failed = 0
    with ThreadPoolExecutor(max_workers=args.num_thread) as pool:
        for idx, blob in pool.map(
                lambda it: _encode_one(it, args.root, args), items):
            if blob is None:
                failed += 1
                continue
            rec.write_idx(idx, blob)
            done += 1
            if done % 1000 == 0:
                print(f"{done} images, {time.time() - t0:.1f}s")
    rec.close()
    print(f"wrote {done} records ({failed} failures) to {args.prefix}.rec "
          f"in {time.time() - t0:.1f}s")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="make an image RecordIO database")
    p.add_argument("prefix", help="output prefix (prefix.lst/.rec/.idx)")
    p.add_argument("root", help="image root directory")
    p.add_argument("--list", action="store_true",
                   help="phase 1: build the .lst file")
    p.add_argument("--recursive", action="store_true",
                   help="label images by subdirectory")
    p.add_argument("--shuffle", action=argparse.BooleanOptionalAction,
                   default=True, help="shuffle the list (--no-shuffle off)")
    p.add_argument("--train-ratio", type=float, default=1.0)
    p.add_argument("--resize", type=int, default=0,
                   help="resize shorter side, 0 = keep")
    p.add_argument("--center-crop", action="store_true")
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--encoding", default=".jpg", choices=[".jpg", ".png"])
    p.add_argument("--pass-through", action="store_true",
                   help="pack raw file bytes without re-encoding")
    p.add_argument("--num-thread", type=int, default=8)
    args = p.parse_args(argv)
    if args.list:
        write_list(args)
    else:
        make_rec(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
