"""Locale auto-detection and string maps (port of tpu_rvc/utils/i18n.py;
reference i18n/i18n.py:13 `I18nAuto`).

The locale JSONs are the port's own copy, tpu_rvc_torch/assets/i18n/
<lang>.json, {key: translation}.  A missing key falls through to the key
itself, so the default language (en_US) needs no file.

`locale.getdefaultlocale()`, which the JAX module calls, is deprecated
and warns from Python 3.11 on; `default_language` keeps its POSIX
semantics (the first of LC_ALL, LC_CTYPE, LANG, LANGUAGE that is set,
normalised the same way) without the warning.
"""

from __future__ import annotations

import ast
import json
import locale
import os
from pathlib import Path
from typing import Dict, Optional

LOCALE_DIR = Path(__file__).parent.parent / "assets" / "i18n"


def default_language() -> Optional[str]:
    """The language code `locale.getdefaultlocale()[0]` gives on POSIX:
    None for an unset environment or the C locale."""
    for var in ("LC_ALL", "LC_CTYPE", "LANG", "LANGUAGE"):
        name = os.environ.get(var)
        if name:
            if var == "LANGUAGE":
                name = name.split(":")[0]
            break
    else:
        name = "C"
    return locale._parse_localename(name)[0]


def load_language_list(language: str) -> Dict[str, str]:
    path = LOCALE_DIR / f"{language}.json"
    if not path.exists():
        return {}
    return json.loads(path.read_text())


class I18nAuto:
    def __init__(self, language: Optional[str] = None):
        if language in (None, "Auto", "auto"):
            language = default_language() or "en_US"
        if not (LOCALE_DIR / f"{language}.json").exists():
            language = "en_US"
        self.language = language
        self.language_map = load_language_list(language)

    def __call__(self, key: str) -> str:
        return self.language_map.get(key, key)

    def __repr__(self):
        return f"Use Language: {self.language}"


def scan_i18n_keys(source_dir: str) -> set:
    """Collect the i18n("...") keys of the sources under `source_dir`
    (reference scan_i18n.py role)."""
    keys = set()
    for root, _, files in os.walk(source_dir):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(root, f)) as fh:
                try:
                    tree = ast.parse(fh.read())
                except SyntaxError:
                    continue
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "i18n"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    keys.add(node.args[0].value)
    return keys
