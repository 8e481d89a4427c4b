"""Asset integrity checks and downloads (port of tpu_rvc/utils/assets.py;
reference infer/lib/rvcmd.py and tools/checksum), stdlib only.

Checksums live in `sha256.env` as `sha256_<name> = <hex>` lines, the
reference's format.  Each key maps to a path under `assets/` in the
layout the reference's downloader writes (`asset_relpath`).  Downloads go
through a `.part` file and are checked against the expected sha256
before they replace the destination.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import socket
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Dict, Optional, Sequence

DEFAULT_MIRROR = ("https://huggingface.co/lj1995/VoiceConversionWebUI/"
                  "resolve/main")
MIRRORS = (
    DEFAULT_MIRROR,
    "https://hf-mirror.com/lj1995/VoiceConversionWebUI/resolve/main",
)
# the real payloads the product loads (reference rvc/hubert.py:265,
# rvc/f0/rmvpe.py:16, infer/modules/train/train.py:317-354,
# infer/modules/uvr5/mdxnet.py:232): (path under assets/, path on a mirror)
CORE_ASSETS = (
    ("hubert/hubert_base.pt", "hubert_base.pt"),
    ("rmvpe/rmvpe.pt", "rmvpe.pt"),
    ("pretrained_v2/f0G48k.pth", "pretrained_v2/f0G48k.pth"),
    ("pretrained_v2/f0D48k.pth", "pretrained_v2/f0D48k.pth"),
    ("uvr5_weights/onnx_dereverb_By_FoxJoy/vocals.onnx",
     "uvr5_weights/onnx_dereverb_By_FoxJoy/vocals.onnx"),
)


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for b in iter(lambda: f.read(chunk), b""):
            h.update(b)
    return h.hexdigest()


def load_checksums(env_path: str = "sha256.env") -> Dict[str, str]:
    """`sha256_<name> = <hex>` lines -> {name: hex}; the published file
    pads the `=` with spaces.  A missing file gives {}."""
    out = {}
    if not os.path.exists(env_path):
        return out
    with open(env_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if "=" in line and line.startswith("sha256_"):
                k, v = line.split("=", 1)
                out[k[len("sha256_"):].strip()] = v.strip()
    return out


def asset_relpath(name: str) -> str:
    """A sha256.env key (`v2_f0G48k_pth`, `uvr5_vocals_onnx`, ...) -> its
    path under assets/ (reference rvcmd.py:48-131: hubert/, rmvpe/,
    pretrained/, pretrained_v2/, uvr5_weights/)."""
    if name == "hubert_base_pt":
        return "hubert/hubert_base.pt"
    if name.startswith("rmvpe_"):
        return f"rmvpe/rmvpe.{name.rsplit('_', 1)[1]}"
    if name == "uvr5_vocals_onnx":
        return "uvr5_weights/onnx_dereverb_By_FoxJoy/vocals.onnx"
    for pref, sub in (("v1_", "pretrained"), ("v2_", "pretrained_v2"),
                      ("uvr5_", "uvr5_weights")):
        if name.startswith(pref):
            stem, ext = name[len(pref):].rsplit("_", 1)
            return f"{sub}/{stem}.{ext}"
    if "." in name:  # a literal file name
        return name
    stem, ext = name.rsplit("_", 1) if "_" in name else (name, "bin")
    return f"{stem}.{ext}"


def check_model(dir_name: Path, model_name: str, hash_str: str,
                remove_incorrect: bool = False) -> bool:
    """Does dir_name/model_name exist with this sha256?  A wrong file is
    deleted when `remove_incorrect` (reference rvcmd.check_model,
    rvcmd.py:19)."""
    target = Path(dir_name) / model_name
    if not target.exists():
        return False
    ok = sha256_file(str(target)) == hash_str
    if not ok and remove_incorrect:
        target.unlink()
    return ok


def check_all_assets(root: str = ".") -> bool:
    """Every asset of root/sha256.env present under root/assets/ with its
    sha256 (reference rvcmd.py:48); no sha256.env checks nothing."""
    ok = True
    for name, hexhash in load_checksums(
            os.path.join(root, "sha256.env")).items():
        if not check_model(Path(root) / "assets", asset_relpath(name),
                           hexhash):
            ok = False
    return ok


def download_file(url: str, dest: str, expected_sha256: Optional[str] = None,
                  timeout: float = 60.0) -> str:
    """Fetch url into dest through dest.part; IOError, and no dest, when
    the sha256 differs from `expected_sha256`."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".part"
    with urllib.request.urlopen(url, timeout=timeout) as r, \
            open(tmp, "wb") as f:
        for b in iter(lambda: r.read(1 << 20), b""):
            f.write(b)
    if expected_sha256 and sha256_file(tmp) != expected_sha256:
        os.unlink(tmp)
        raise IOError(f"sha256 mismatch for {url}")
    os.replace(tmp, dest)
    return dest


def _remote_path(rel: str) -> str:
    """A mirror's layout is assets/'s, except that hubert/ and rmvpe/
    files lie at the mirror's root."""
    head, _, tail = rel.partition("/")
    return tail if head in ("hubert", "rmvpe") and tail else rel


def download_all_assets(root: str = ".", mirror: str = DEFAULT_MIRROR
                        ) -> None:
    """Fetch every asset of root/sha256.env that is missing or corrupt."""
    for name, hexhash in load_checksums(
            os.path.join(root, "sha256.env")).items():
        rel = asset_relpath(name)
        dest = os.path.join(root, "assets", rel)
        if os.path.exists(dest) and sha256_file(dest) == hexhash:
            continue
        download_file(f"{mirror}/{_remote_path(rel)}", dest, hexhash)


def attempt_asset_report(root: str = ".", timeout: float = 30.0,
                         mirrors: Sequence[str] = MIRRORS) -> dict:
    """Try to fetch every core asset from each mirror in turn and record
    what happened, failures included, as a JSON-ready report: a name
    lookup of each mirror's host, then for each asset either a file that
    verifies already or the attempts (reference download_all_assets,
    rvcmd.py:165).  A file on disk that fails its sha256 is refetched."""
    report = {
        "generated_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "dns_probe": {},
        "attempts": [],
        "downloaded": [],
    }
    for host in dict.fromkeys(urllib.parse.urlsplit(m).hostname
                              for m in mirrors):
        try:
            addr = socket.getaddrinfo(host, 443)[0][4][0]
            report["dns_probe"][host] = {"ok": True, "addr": addr}
        except OSError as e:
            report["dns_probe"][host] = {
                "ok": False, "error": f"{type(e).__name__}: {e}"}

    expected = {asset_relpath(k): v for k, v in load_checksums(
        os.path.join(root, "sha256.env")).items()}
    for dest_rel, remote_rel in CORE_ASSETS:
        dest = os.path.join(root, "assets", dest_rel)
        want = expected.get(dest_rel)
        if os.path.exists(dest):
            if want is None or sha256_file(dest) == want:
                report["downloaded"].append(dest_rel)
                continue
            report["attempts"].append(
                {"asset": dest_rel, "url": None, "ok": False,
                 "error": "existing file failed sha256 check — refetching"})
        for mirror in mirrors:
            url = f"{mirror}/{remote_rel}"
            entry = {"asset": dest_rel, "url": url}
            try:
                download_file(url, dest, expected_sha256=want,
                              timeout=timeout)
                entry.update(ok=True, sha256_verified=want is not None)
                report["downloaded"].append(dest_rel)
            except Exception as e:  # noqa: BLE001 - the report records it
                entry.update(ok=False, error=f"{type(e).__name__}: {e}")
            report["attempts"].append(entry)
            if entry["ok"]:
                break
    report["all_ok"] = len(report["downloaded"]) == len(CORE_ASSETS)
    return report
