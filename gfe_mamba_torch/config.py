"""YAML configs and the typed trees (counterpart of
``gfe_mamba_tpu/config.py``), without PyYAML: the flat reader of the
GFE entry points' configs, and the nested reader of the segmentation
configs (:func:`parse_nested_yaml`, :func:`load_nested_config`).

The flat reader takes what the configs of ``configs/`` use: one flat mapping
of scalars, single- or double-quoted strings, flow lists ``[a, b]`` of
scalars, comments and blank lines.  Scalars resolve as
``yaml.safe_load``'s YAML 1.1 resolver resolves them: ``1.0e-4`` is a
float but ``1e-4`` (no dot, no exponent sign) a string; ``yes/no/on/off``
and ``true/false`` in three cases are booleans; ``~``, ``null`` and an
empty value are None; ``0x``, ``0b``, a leading ``0`` (octal), ``_``
separators and ``a:b`` base-60 integers are integers; ``YYYY-MM-DD`` is a
``datetime.date``.  Anything else (nesting, block lists, anchors,
aliases, tags, block or multi-line scalars, flow mappings, nested flow
lists, full timestamps) raises ``ValueError``.  ``load_config`` turns
lists into tuples, as the JAX loader does.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import re
from dataclasses import dataclass
from typing import Sequence

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")
_TIMESTAMP = re.compile(r"""^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}
                        (?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}
                        (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?$
                        """, re.X)
# a plain scalar may not start with these (YAML indicators)
_INDICATORS = set("[]{}#&*!|>'\"%@`,")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _resolve_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def resolve_plain(text: str):
    """A plain (unquoted) scalar as ``yaml.safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _resolve_int(text)
    if _FLOAT.match(text):
        return _resolve_float(text)
    date = _DATE.match(text)
    if date:
        return datetime.date(*(int(g) for g in date.groups()))
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are not supported: {text!r}")
    return text


class _Cursor:
    """Reads one line's scalars left to right."""

    def __init__(self, line: str, lineno: int):
        self.s, self.i, self.lineno = line, 0, lineno

    def fail(self, what: str):
        raise ValueError(f"line {self.lineno}: {what}: {self.s!r}")

    def skip_spaces(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def at_end(self) -> bool:
        """Only spaces or a comment left."""
        self.skip_spaces()
        return self.i >= len(self.s) or self.s[self.i] == "#"

    def quoted(self) -> str:
        quote, s = self.s[self.i], self.s
        self.i += 1
        out = []
        while True:
            if self.i >= len(s):
                self.fail("unterminated quoted scalar (multi-line scalars "
                          "are not supported)")
            ch = s[self.i]
            if quote == "'" and ch == "'":
                if s.startswith("''", self.i):
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if quote == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            if quote == '"' and ch == "\\":
                code = s[self.i + 1:self.i + 2]
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                    self.i += 2
                elif code in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[code]
                    digits = s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not all(
                            c in "0123456789abcdefABCDEF" for c in digits):
                        self.fail("bad escape")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                else:
                    self.fail("bad escape")
                continue
            out.append(ch)
            self.i += 1

    def plain(self, in_flow: bool) -> str:
        """A plain scalar up to a comment, a ': ' (a nested mapping, which
        raises) or, inside a flow list, ',' or ']'."""
        s, start = self.s, self.i
        if s[start] in _INDICATORS or (
                s[start] in "-?:" and s[start + 1:start + 2] in ("", " ")):
            self.fail("unsupported YAML construct")
        while self.i < len(s):
            ch = s[self.i]
            if ch == "#" and s[self.i - 1] == " ":
                break
            if ch == "#" and s[self.i - 1] == "\t":
                self.fail("a tab before a comment")
            if ch == ":" and s[self.i + 1:self.i + 2] in ("", " ", "\t") \
                    + ((",", "]", "[", "{", "}") if in_flow else ()):
                self.fail("nested mappings are not supported")
            if in_flow and ch in ",[]{}":
                break
            self.i += 1
        return s[start:self.i].rstrip(" \t")

    def scalar(self, in_flow: bool = False):
        if self.s[self.i] in "'\"":
            return self.quoted()
        return resolve_plain(self.plain(in_flow))

    def flow_list(self, nested: bool = False) -> list:
        """A flow list of scalars; of flow lists too where ``nested``."""
        self.i += 1   # '['
        items = []
        while True:
            self.skip_spaces()
            if self.i >= len(self.s):
                self.fail("unterminated flow list (multi-line flow lists "
                          "are not supported)")
            if self.s[self.i] == "]":
                self.i += 1
                return items
            if self.s[self.i] == "[" and nested:
                items.append(self.flow_list(nested))
            elif self.s[self.i] in "[{":
                self.fail("nested flow collections are not supported")
            else:
                items.append(self.scalar(in_flow=True))
            self.skip_spaces()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "]":
                self.fail("expected ',' or ']' in a flow list")

    def key(self):
        """The mapping key and the ':' after it."""
        if self.s[self.i] in "'\"":
            key = self.quoted()
        else:
            end = self.i
            while end < len(self.s) and not (
                    self.s[end] == ":"
                    and self.s[end + 1:end + 2] in ("", " ", "\t")):
                if self.s[end] == "#" and end > 0 \
                        and self.s[end - 1] in " \t":
                    break
                end += 1
            if end >= len(self.s) or self.s[end] != ":":
                self.fail("expected 'key: value'")
            text = self.s[self.i:end].rstrip(" \t")
            if not text or text[0] in _INDICATORS or text[0] in "-?":
                self.fail("unsupported YAML construct")
            key = resolve_plain(text)
            self.i = end
        self.skip_spaces()
        if self.s[self.i:self.i + 1] != ":":
            self.fail("expected ':' after the key")
        self.i += 1
        return key

    def value(self, nested: bool = False):
        if self.at_end():
            return None
        if self.s[self.i] == "[":
            value = self.flow_list(nested)
        else:
            value = self.scalar()
        if not self.at_end():
            self.fail("unexpected text after the value")
        return value


def parse_yaml(text: str) -> dict:
    """One flat YAML mapping, as ``yaml.safe_load`` reads it."""
    out: dict = {}
    started = False
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped == "---" and not started and line.startswith("---"):
            started = True
            continue
        started = True
        if line[0] in " \t":
            raise ValueError(f"line {lineno}: nested or multi-line YAML is "
                             f"not supported: {line!r}")
        cur = _Cursor(line, lineno)
        key = cur.key()
        out[key] = cur.value()
    if not out:
        raise ValueError("the YAML holds no mapping")
    return out


def _block_lines(text: str) -> list[list]:
    """``[indent, content, lineno]`` of every line that holds YAML: blank
    and comment-only lines and a leading ``---`` dropped."""
    lines, started = [], False
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped == "---" and not started and line.startswith("---"):
            started = True
            continue
        started = True
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError(f"line {lineno}: a tab in the indentation: "
                             f"{line!r}")
        lines.append([len(line) - len(body), body.rstrip(), lineno])
    return lines


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _is_entry(content: str, lineno: int) -> bool:
    """Whether ``content`` opens a ``key: value`` entry (else it is a
    value)."""
    if content.startswith("["):
        return False
    cur = _Cursor(content, lineno)
    if content[0] in "'\"":
        cur.quoted()
        cur.skip_spaces()
        return content[cur.i:cur.i + 1] == ":"
    for i, ch in enumerate(content):
        if ch == "#" and i and content[i - 1] in " \t":
            return False
        if ch == ":" and content[i + 1:i + 2] in ("", " ", "\t"):
            return True
    return False


class _Blocks:
    """The block structure of a nested YAML text: mappings and sequences
    by indentation, each leaf read by :class:`_Cursor`."""

    def __init__(self, text: str):
        self.lines = _block_lines(text)

    def indent(self, i: int) -> int:
        return self.lines[i][0] if i < len(self.lines) else -1

    def block(self, i: int, indent: int):
        """The block at line ``i`` (indented ``indent``) and the line after
        it."""
        if _is_item(self.lines[i][1]):
            return self.sequence(i, indent)
        if _is_entry(self.lines[i][1], self.lines[i][2]):
            return self.mapping(i, indent)
        _, content, lineno = self.lines[i]
        value = _Cursor(content, lineno).value(nested=True)
        if self.indent(i + 1) > indent:
            raise ValueError(f"line {self.lines[i + 1][2]}: multi-line "
                             f"scalars are not supported")
        return value, i + 1

    def nested(self, i: int, indent: int, of_key: bool):
        """The value of an entry (``of_key``) or item with nothing after
        its key or dash: the deeper block below it, or for an entry a
        sequence at its key's own indent; else None."""
        below = self.indent(i)
        if below > indent or (of_key and below == indent
                              and _is_item(self.lines[i][1])):
            return self.block(i, below)
        return None, i

    def mapping(self, i: int, indent: int):
        out: dict = {}
        while self.indent(i) == indent and not _is_item(self.lines[i][1]):
            _, content, lineno = self.lines[i]
            cur = _Cursor(content, lineno)
            key = cur.key()
            if cur.at_end():
                out[key], i = self.nested(i + 1, indent, True)
                continue
            out[key] = cur.value(nested=True)
            i += 1
            if self.indent(i) > indent:
                raise ValueError(f"line {self.lines[i][2]}: multi-line "
                                 f"scalars are not supported")
        if self.indent(i) > indent:
            raise ValueError(f"line {self.lines[i][2]}: bad indentation")
        return out, i

    def sequence(self, i: int, indent: int):
        out: list = []
        while self.indent(i) == indent and _is_item(self.lines[i][1]):
            _, content, lineno = self.lines[i]
            rest = content[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                value, i = self.nested(i + 1, indent, False)
            else:
                # the item's content is a block of its own, at its column
                column = indent + len(content) - len(rest)
                self.lines[i] = [column, rest, lineno]
                value, i = self.block(i, column)
            out.append(value)
        if self.indent(i) > indent:
            raise ValueError(f"line {self.lines[i][2]}: bad indentation")
        return out, i


def parse_nested_yaml(text: str):
    """A nested YAML document, as ``yaml.safe_load`` reads it: block
    mappings at any depth; block sequences (at their key's indent or
    deeper) of scalars, of mappings (``- name: ...`` with the entries
    below at the name's column) and of sequences; flow lists, nested
    ones too; and the scalar rules of :func:`parse_yaml`.  Anchors,
    aliases, tags, flow mappings and multi-line or block scalars raise
    ``ValueError``."""
    blocks = _Blocks(text)
    if not blocks.lines:
        return None
    value, end = blocks.block(0, blocks.lines[0][0])
    if end < len(blocks.lines):
        raise ValueError(f"line {blocks.lines[end][2]}: bad indentation")
    return value


def parse_value(text: str):
    """One inline YAML value (a scalar or a flow list), as
    ``yaml.safe_load(text)`` reads it."""
    return _Cursor(text.strip(), 0).value(nested=True)


def load_nested_config(path: str, overrides=()) -> dict:
    """A nested YAML config file (``seg_train.py::load_nested_config``):
    each override ``dotted.key=value`` sets that key, making the mappings
    on its way, to the YAML value ``value``."""
    with open(path, "r", encoding="utf-8") as f:
        config = parse_nested_yaml(f.read())
    if not isinstance(config, dict):
        raise ValueError(f"{path}: the YAML holds no mapping")
    for item in overrides or ():
        keys, value = item.split("=", 1)
        node = config
        parts = keys.split(".")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = parse_value(value)
    return config


def load_config(file_path: str) -> dict:
    """YAML file -> dict, lists coerced to tuples (JAX ``config.py:20-27``)."""
    with open(file_path, "r", encoding="utf-8") as f:
        config = parse_yaml(f.read())
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in config.items()}


def _from_flat(cls, flat: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in flat.items() if k in names})


@dataclass(frozen=True)
class GanVitConfig:
    """Stage-1 GAN-ViT training config (configs/main_gan_vit_config.yaml)."""

    train_path: str = ""
    eval_path: str = ""
    train_bc: int = 1
    eval_bc: int = 1
    img_sz: Sequence[int] = (160, 160, 96)
    num_epochs: int = 200
    val_inter: int = 4
    save_inter: int = 5
    split_batches: bool = False
    mixed_precision: str = "bf16"
    log_with: str = "tensorboard"
    project_dir: str = "weights"
    gradient_accumulation_steps: int = 1
    is_debug: bool = False
    f_maps: Sequence[int] = (64, 128, 256)
    adv_weight: float = 0.01
    perceptual_weight: float = 0.001
    lr_g: float = 1e-4
    lr_d: float = 5e-4
    warmup_epochs: int = 10
    grad_clip: float = 1.0
    seed: int = 0

    @classmethod
    def from_yaml(cls, path: str) -> "GanVitConfig":
        return _from_flat(cls, load_config(path))


@dataclass(frozen=True)
class ClassifyConfig:
    """Stage-2 classifier config (configs/classify_mamba_config.yaml)."""

    train_path: str = ""
    eval_path: str = ""
    table_path: str = ""
    train_bc: int = 2
    eval_bc: int = 2
    img_sz: Sequence[int] = (160, 160, 96)
    num_epochs: int = 200
    days_threshold: int = -1
    val_inter: int = 1
    save_inter: int = 5
    resume_path: str = ""
    gan_ckpt: str = ""
    pth_dir: str = ""
    split_batches: bool = False
    mixed_precision: str = "bf16"
    log_with: str = "tensorboard"
    project_dir: str = "weights/classifier"
    gradient_accumulation_steps: int = 1
    is_debug: bool = False
    latent_dim: int = 16
    f_maps: Sequence[int] = (64, 128, 256)
    seq_length: int = 4
    dim: int = 512
    dim_out: int = 1
    depth: int = 6
    heads: int = 8
    attn_dropout: float = 0.1
    ff_dropout: float = 0.1
    mixer: str = "mamba"
    lr: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0

    @classmethod
    def from_yaml(cls, path: str) -> "ClassifyConfig":
        return _from_flat(cls, load_config(path))


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) process grid (``parallel/mesh.py::make_mesh``);
    -1 means "all remaining ranks".  The default is pure data parallelism
    over every process (the reference's only strategy, torch DDP --
    main_gan_vit.py:31,54-56); a ``model`` axis splits the large ViT
    patch-embedding, cross-attention K/V and MoE expert kernels
    (``parallel/sharding.py``)."""

    data: int = -1
    model: int = 1
