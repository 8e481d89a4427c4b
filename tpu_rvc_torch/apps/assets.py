"""Asset tools (port of apps/cli/assets.py; reference rvcmd roles).

    python -m tpu_rvc_torch.apps.assets check [--root .]
    python -m tpu_rvc_torch.apps.assets download [--root .] [--mirror URL]
    python -m tpu_rvc_torch.apps.assets gen [--out sha256.env] FILE...

`check` exits 1 when an asset of sha256.env is missing or corrupt;
`download` fetches those from the mirror; `gen` writes
`sha256_<file name>=<hex>` lines, the format of native/checksum.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    from tpu_rvc_torch.utils import assets

    p = argparse.ArgumentParser(prog="python -m tpu_rvc_torch.apps.assets",
                                description="tpu_rvc_torch asset tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    sc = sub.add_parser("check", help="verify all assets in sha256.env")
    sc.add_argument("--root", default=".")
    sd = sub.add_parser("download", help="fetch missing/corrupt assets")
    sd.add_argument("--root", default=".")
    sd.add_argument("--mirror", default=assets.DEFAULT_MIRROR)
    sg = sub.add_parser("gen", help="regenerate sha256.env for files")
    sg.add_argument("--out", default="sha256.env")
    sg.add_argument("files", nargs="+")
    args = p.parse_args(argv)

    if args.cmd == "check":
        ok = assets.check_all_assets(args.root)
        print("all assets OK" if ok else "missing or corrupt assets")
        sys.exit(0 if ok else 1)
    elif args.cmd == "download":
        assets.download_all_assets(args.root, args.mirror)
        print("done")
    else:
        with open(args.out, "w") as f:
            for path in args.files:
                f.write(f"sha256_{os.path.basename(path)}="
                        f"{assets.sha256_file(path)}\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
