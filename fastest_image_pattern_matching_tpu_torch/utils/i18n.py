"""UI-string localization (a copy of
fastest_image_pattern_matching_tpu/utils/i18n.py) — the headless analogue of the reference's
`MatchTool.Lang` INI mechanism (MatchTool/MatchToolDlg.cpp:618-709 reads
`[<Language>] key=translation` sections via GetPrivateProfileString and
relabels every control).

The loader is format-compatible with the reference's .Lang files, so a
user can point --lang-file at an existing MatchTool.Lang and get the
same translations in the CLI's output table. We ship only our own
built-in English defaults (the reference's translation content is its
own asset).
"""

from __future__ import annotations

from typing import Dict, Optional

# Keys mirror the reference's label keys (MatchToolDlg.cpp:632-706).
_BUILTIN_EN = {
    "ImageMatchTool": "Image Match Tool",
    "TargetNumber": "Target number",
    "MaxOverLapRatio": "Max overlap ratio",
    "Score(Similarity)": "Score (similarity)",
    "ToleranceAngle": "Tolerance angle",
    "MinReducedArea": "Min reduced area",
    "Execute": "Execute",
    "Index": "Index",
    "Score": "Score",
    "Angle(deg)": "Angle(deg)",
    "PosX": "PosX",
    "PosY": "PosY",
    "ExecutionTime": "Execution time",
    "TotalNumber": "Total number",
    "SourceImageSize": "Source image size",
    "DstImageSize": "Template image size",
}


def parse_lang_file(path: str) -> Dict[str, Dict[str, str]]:
    """Parse a MatchTool-format .Lang INI: {language: {key: text}}.

    Same semantics as GetPrivateProfileString: '[Section]' headers, one
    'key=value' per line, no escapes, later duplicates win. Encoded
    UTF-8 (the reference's file) or UTF-16 (MFC also accepts it)."""
    raw = open(path, "rb").read()
    if raw[:2] in (b"\xff\xfe", b"\xfe\xff"):
        text = raw.decode("utf-16")
    else:
        text = raw.decode("utf-8-sig", errors="replace")
    langs: Dict[str, Dict[str, str]] = {}
    cur: Optional[Dict[str, str]] = None
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith((";", "#")):
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = langs.setdefault(line[1:-1], {})
            continue
        if cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k.strip()] = v.strip()
    return langs


class Translator:
    """t(key) -> localized string; unknown keys fall back to built-in
    English, then to the key itself (the reference leaves labels
    untouched when a key is missing)."""

    def __init__(self, lang: Optional[str] = None,
                 lang_file: Optional[str] = None):
        self.lang = lang
        self.table: Dict[str, str] = {}
        if bool(lang) != bool(lang_file):
            raise ValueError(
                "lang and lang_file must be given together "
                f"(got lang={lang!r}, lang_file={lang_file!r})")
        if lang_file and lang:
            langs = parse_lang_file(lang_file)
            if lang not in langs:
                raise ValueError(
                    f"language {lang!r} not in {lang_file} "
                    f"(has: {sorted(langs)})")
            self.table = langs[lang]

    def t(self, key: str) -> str:
        return self.table.get(key, _BUILTIN_EN.get(key, key))


def available_languages(lang_file: str) -> list:
    return sorted(parse_lang_file(lang_file))
