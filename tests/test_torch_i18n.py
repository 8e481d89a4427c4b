"""tpu_rvc_torch's i18n against tpu_rvc's on the CPU: every locale's map,
the fallbacks of an unknown locale and of "Auto" under a given LANG, the
i18n keys the two web layouts use, and the port's copy of the locale
files."""

import os
import warnings

import pytest

from tpu_rvc.utils import i18n as jax_i18n
from tpu_rvc_torch.utils import i18n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCALES = sorted(n[:-len(".json")] for n in os.listdir(jax_i18n.LOCALE_DIR))


def jax_auto(language):
    """tpu_rvc's I18nAuto; its locale.getdefaultlocale() warns (deprecated
    since Python 3.11), which is the JAX package's affair here."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jax_i18n.I18nAuto(language)


def port_auto(language):
    """The port's I18nAuto, with every warning an error: it must not
    call the deprecated lookup."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return i18n.I18nAuto(language)


def test_thirteen_locales():
    assert len(LOCALES) == 13 and "en_US" in LOCALES


@pytest.mark.parametrize("lang", LOCALES)
def test_locale_map_matches_jax(lang):
    got, want = port_auto(lang), jax_auto(lang)
    assert got.language == want.language == lang
    assert got.language_map == want.language_map
    assert len(got.language_map) > 50
    for key in ("Train", "Model Inference", "no such key"):
        assert got(key) == want(key)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("env,want_lang", [
    ({"LANG": "ja_JP.UTF-8"}, "ja_JP"),
    ({"LANG": "zh_CN.UTF-8", "LC_ALL": "ko_KR.UTF-8"}, "ko_KR"),
    ({"LANGUAGE": "fr_FR:en_US"}, "fr_FR"),
    ({"LANG": "de_DE.UTF-8"}, "en_US"),     # no file: the default
    ({"LANG": "C"}, "en_US"),
    ({}, "en_US"),
])
def test_auto_follows_the_environment_as_jax(monkeypatch, env, want_lang):
    for var in ("LC_ALL", "LC_CTYPE", "LANG", "LANGUAGE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    for arg in (None, "Auto", "auto"):
        got, want = port_auto(arg), jax_auto(arg)
        assert got.language == want.language == want_lang, (env, arg)
        assert got.language_map == want.language_map


def test_unknown_locale_falls_back_as_jax():
    got, want = port_auto("xx_XX"), jax_auto("xx_XX")
    assert got.language == want.language == "en_US"
    assert got("Train") == want("Train") == "Train"
    assert i18n.load_language_list("xx_XX") == {} == \
        jax_i18n.load_language_list("xx_XX")


def test_scan_keys_of_port_apps_match_jax_apps():
    """The keys the port's layout asks for are the JAX layout's, and each
    package's scanner reads both trees alike."""
    port_dir = os.path.join(REPO, "tpu_rvc_torch", "apps")
    jax_dir = os.path.join(REPO, "apps")
    got = i18n.scan_i18n_keys(port_dir)
    want = jax_i18n.scan_i18n_keys(jax_dir)
    assert got == want and len(got) > 80
    assert jax_i18n.scan_i18n_keys(port_dir) == got
    assert i18n.scan_i18n_keys(jax_dir) == want
    # every key has its translation in every locale file
    for lang in LOCALES:
        assert got <= set(i18n.load_language_list(lang)), lang


def test_locale_files_are_byte_copies():
    names = sorted(os.listdir(jax_i18n.LOCALE_DIR))
    assert sorted(os.listdir(i18n.LOCALE_DIR)) == names
    for name in names:
        with open(os.path.join(jax_i18n.LOCALE_DIR, name), "rb") as f:
            want = f.read()
        with open(os.path.join(i18n.LOCALE_DIR, name), "rb") as f:
            assert f.read() == want, name
