"""MultiFace preprocessing: GT depth + foreground masks from tracked meshes,
and the dataset download manifest logic (port of
diner_tpu.preprocess.multiface).

Behavioral reference: deps/multiface/process_dataset.py:50-110 (pyrender depth
+ mask render per frame/camera; here the batched rasterizer on `device`,
preprocess/rasterizer.py) and deps/multiface/download_dataset.py
(manifest-driven download with md5 checks and up to MAX_TRY=50 retries) in
malteprinzler/diner. The download side is host code on the standard library,
as in JAX.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.data.codecs import write_depth_png
from diner_tpu_torch.image_ops.png import write_png
from diner_tpu_torch.preprocess.rasterizer import render_depth

MAX_TRY = 50


def render_frame(vertices, faces, krt_entry, H: int, W: int,
                 mm_to_m: bool = True, device="cuda"):
    """Render (depth [m] float32, mask bool) for one camera from a tracked
    mesh, tensors on `device`.

    krt_entry: dict with 'intrin' (3, 3) and 'extrin' (3, 4) as parsed by
    diner_tpu_torch.data.multiface.load_krt (MultiFace KRT, millimetre
    world).
    """
    ext = np.eye(4, dtype=np.float64)
    ext[:3, :4] = np.asarray(krt_entry["extrin"], np.float64)
    depth, mask = render_depth(vertices, faces, np.asarray(krt_entry["intrin"]),
                               ext, H, W, device=device)
    if mm_to_m:
        depth = depth / 1000.0
    return depth, mask


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_frame_outputs(depth_m, mask, depth_path, mask_path):
    """uint16 depth PNG (1e-4 m) + 8-bit mask PNG, the layout the MultiFace
    dataset loader reads (src/data/multiface.py depths/ masks/ trees), both
    through the port's PNG codec."""
    Path(depth_path).parent.mkdir(parents=True, exist_ok=True)
    Path(mask_path).parent.mkdir(parents=True, exist_ok=True)
    write_depth_png(depth_path, _host(depth_m))
    write_png(mask_path, (_host(mask) * 255).astype(np.uint8))


def md5sum(path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def default_fetch(url, out_path):
    """urllib-based fetcher (supports http(s):// and file:// URLs).

    Plays the role of the reference's wget shell-out
    (deps/multiface/download_dataset.py:136-141); streamed to disk so
    multi-GB tars don't buffer in memory.
    """
    import shutil
    import urllib.request

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = out_path.with_suffix(out_path.suffix + ".part")
    with urllib.request.urlopen(url) as resp, open(tmp, "wb") as fh:
        shutil.copyfileobj(resp, fh)
    tmp.replace(out_path)


def verify_or_download(entries, dest_root, fetch=None, max_try: int = MAX_TRY):
    """Manifest-driven download/verify.

    entries: [(relative_path, url, md5)]; fetch: callable(url, out_path),
    or None (verify-only). Use `default_fetch` for real downloads. Returns
    the list of entries that are still missing/corrupt after max_try
    attempts.
    """
    dest_root = Path(dest_root)
    failed = []
    for rel, url, md5 in entries:
        out = dest_root / rel
        ok = out.exists() and (md5 is None or md5sum(out) == md5)
        tries = 0
        while not ok and fetch is not None and tries < max_try:
            tries += 1
            out.parent.mkdir(parents=True, exist_ok=True)
            try:
                fetch(url, out)
                ok = md5 is None or md5sum(out) == md5
            except Exception:
                ok = False
        if not ok:
            failed.append((rel, url, md5))
    return failed


# --- official-manifest download pipeline -----------------------------------
#
# Mirrors deps/multiface/download_dataset.py in malteprinzler/diner:
# a JSON config selects entities/categories/expressions (:169,182-186), the
# per-entity S3 index.html lists the tar files (:96-109), a CHECKSUM file
# provides md5s (:50-80), tars are fetched with retries (:131-152) and
# extracted (:23-45). Re-implemented on the stdlib (urllib + html.parser +
# tarfile) — no requests/bs4/wget/os.system.

S3_ROOT = ("https://fb-baas-f32eacb9-8abb-11eb-b2b8-4857dd089e15"
           ".s3.amazonaws.com/MugsyDataRelease/v0.0/identities/")
_MISC_FILES = {"CHECKSUM", "index.html"}


def parse_download_config(path):
    """Parse the official download_dataset.json manifest
    (deps/multiface/download_dataset.json): entity list, per-category
    booleans (image/mesh/texture/metadata/audio) and expression filter."""
    import json

    cfg = json.loads(Path(path).read_text())
    return {
        "entity": list(cfg["entity"]),
        "image": bool(cfg.get("image", True)),
        "mesh": bool(cfg.get("mesh", True)),
        "texture": bool(cfg.get("texture", False)),
        "metadata": bool(cfg.get("metadata", True)),
        "audio": bool(cfg.get("audio", False)),
        "expression": list(cfg.get("expression", [])),
    }


def parse_index_html(html: str):
    """Extract hrefs from an S3 index.html listing (the reference scrapes
    <a> tags with BeautifulSoup, download_dataset.py:104-109)."""
    from html.parser import HTMLParser

    hrefs = []

    class _A(HTMLParser):
        def handle_starttag(self, tag, attrs):
            if tag == "a":
                for k, v in attrs:
                    if k == "href" and v:
                        hrefs.append(v)

    _A().feed(html)
    return hrefs


def select_files(file_names, cfg):
    """Apply the manifest's category + expression filters to index file
    names (download_dataset.py:110-132). Misc files (CHECKSUM/index.html),
    metadata and audio bypass the expression filter like the reference."""
    keep = []
    for name in file_names:
        base = name.split("/")[-1]
        if "unwrapped_uv" in base and not cfg["texture"]:
            continue
        if "tracked_mesh" in base and not cfg["mesh"]:
            continue
        if "images" in base and not cfg["image"]:
            continue
        if "audio" in base and not cfg["audio"]:
            continue
        if "metadata" in base and not cfg["metadata"]:
            continue
        if base in _MISC_FILES or "metadata" in base or "audio" in base:
            keep.append(name)
        elif any(exp in base for exp in cfg["expression"]):
            keep.append(name)
    return keep


def parse_checksum_file(path):
    """CHECKSUM lines are `<md5> ... <tar_name>` (download_dataset.py:54-56);
    returns {tar_name: md5}."""
    out = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            out[parts[-1].strip()] = parts[0].strip()
    return out


def extract_tar(tar_path, dest=None, marker: bool = True):
    """Extract a .tar next to itself (reference untars in place with a
    `.unzip` marker file, download_dataset.py:23-37). Membership paths are
    validated against traversal before extraction."""
    import tarfile

    tar_path = Path(tar_path)
    dest = Path(dest) if dest else tar_path.parent
    dest_r = dest.resolve()
    with tarfile.open(tar_path) as tf:
        for m in tf.getmembers():
            # link members can point outside dest and later members can
            # write through them — reject outright
            if m.issym() or m.islnk():
                raise ValueError(f"link tar member not allowed: {m.name}")
            target = (dest_r / m.name).resolve()
            # component-wise containment (startswith would accept a sibling
            # like <dest>-evil/)
            if target != dest_r and dest_r not in target.parents:
                raise ValueError(f"unsafe tar member path: {m.name}")
        tf.extractall(dest, filter="fully_trusted")  # members checked above
    if marker:
        Path(str(tar_path) + ".unzip").touch()
    return dest


def download_entity(dest, entity: str, cfg, fetch=default_fetch,
                    root: str = S3_ROOT, max_try: int = MAX_TRY,
                    untar: bool = True, keep_tars: bool = False):
    """Full per-entity pipeline: index -> filter -> fetch+md5 -> untar.

    `root` may be a file:// URL for offline mirrors/tests. Returns
    (downloaded_paths, failed_entries).
    """
    import urllib.request

    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    index_url = f"{root}{entity}/index.html"
    with urllib.request.urlopen(index_url) as resp:
        html = resp.read().decode("utf-8", "replace")
    hrefs = parse_index_html(html)
    wanted = select_files(hrefs, cfg)

    def _url(h):
        return h if "://" in h else f"{root}{entity}/{h}"

    def _name(h):
        return h.split("/")[-1]

    # fetch CHECKSUM first so tar fetches verify in the same pass
    md5s = {}
    chks = [h for h in wanted if _name(h) == "CHECKSUM"]
    if chks:
        chk_path = dest / f"{entity}CHECKSUM"
        if verify_or_download([(chk_path.name, _url(chks[0]), None)], dest,
                              fetch=fetch, max_try=max_try):
            raise RuntimeError(f"could not fetch CHECKSUM for {entity}")
        md5s = parse_checksum_file(chk_path)

    # resume: a tar already extracted (`.unzip` marker) and deleted must
    # not be re-fetched
    entries = [(entity + _name(h), _url(h), md5s.get(_name(h)))
               for h in wanted if _name(h) not in _MISC_FILES
               and not (dest / (entity + _name(h) + ".unzip")).exists()]
    failed = verify_or_download(entries, dest, fetch=fetch, max_try=max_try)
    failed_rels = {rel for rel, _, _ in failed}
    got = [dest / rel for rel, _, _ in entries if rel not in failed_rels]
    if untar:
        for p in got:
            if p.suffix == ".tar" and not Path(str(p) + ".unzip").exists():
                extract_tar(p)
                if not keep_tars:
                    p.unlink()
    return got, failed


def main(argv=None):
    """CLI equivalent of `python deps/multiface/download_dataset.py`: the
    download alone, which renders nothing (render_frame does)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="MultiFace dataset download (manifest-driven)")
    ap.add_argument("--dest", default="data/MULTIFACE")
    ap.add_argument("--download-config", required=True,
                    help="official download_dataset.json manifest")
    ap.add_argument("--root", default=S3_ROOT,
                    help="index root URL (file:// supported for mirrors)")
    ap.add_argument("--max-try", type=int, default=MAX_TRY)
    ap.add_argument("--keep-tars", action="store_true")
    ap.add_argument("--no-untar", action="store_true")
    args = ap.parse_args(argv)

    cfg = parse_download_config(args.download_config)
    all_failed = []
    for entity in cfg["entity"]:
        got, failed = download_entity(
            args.dest, entity, cfg, root=args.root, max_try=args.max_try,
            untar=not args.no_untar, keep_tars=args.keep_tars)
        print(f"{entity}: {len(got)} files ok, {len(failed)} failed")
        all_failed += failed
    if all_failed:
        for rel, url, _ in all_failed:
            print("FAILED:", rel, url)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
