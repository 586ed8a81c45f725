"""Config files with `parent_config` chain inheritance, read without `yaml`
(counterpart of `lidar_rt_tpu.config`).

The reference reads its files with `yaml.safe_load`; the port runs where
no `yaml` is installed, so `load_yaml` reads the subset of YAML that the
configs use and gives what `yaml.safe_load` gives for it:

  * block mappings nested by indentation (spaces), with plain or quoted
    keys and empty values (None);
  * `#` comments outside quotes; single- and double-quoted strings;
  * flow sequences `[a, b, [c]]`;
  * PyYAML's YAML 1.1 scalars: `30_000` is an int, `0.0002` a float,
    `True`/`true`/`yes`/`on` are bools, `null`/`~`/empty are None, and
    `1e-3` (no dot) stays a string, as PyYAML reads it.

Anything outside that subset (anchors and aliases, tags, block scalars,
block sequences, flow mappings, documents markers, directives, tabs,
timestamps, multi-line scalars) raises `ConfigError` naming the file and
line; nothing is guessed.

Train/eval take two files: the experiment config is parsed first and its
values win; the data config's chain only fills keys the experiment config
did not set (`parse(data, parse(exp))`, the reference's train.py:518-519
with the first-loaded-wins merge of lib/arguments/__init__.py:32-42).
`Args` is a read-only attribute view over the nested dicts, so
hyperparameters read as `args.opt.lambda_depth_l1`.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any


class ConfigError(ValueError):
    """A config file outside the subset `load_yaml` reads."""


# PyYAML's implicit resolvers (yaml/resolver.py), in its order.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# Characters that may not start a plain scalar here: YAML's indicators.
_NOT_PLAIN = set("&*!|>%@`{}[]'\"")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0"}


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def resolve_scalar(text: str) -> Any:
    """A plain scalar's value as PyYAML's SafeLoader resolves it."""
    if text and text[0] in "yYnNtTfFoO" and _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if text and text[0] in "-+0123456789." and _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if text and text[0] in "-+0123456789" and _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _NULL.match(text):
        return None
    return text


class _Line:
    """One line of a file being read: a cursor over its characters."""

    def __init__(self, path: str, number: int, text: str):
        self.path, self.number, self.text, self.pos = path, number, text, 0

    def error(self, what: str) -> ConfigError:
        return ConfigError(f"{self.path}:{self.number}: {what} (the port's "
                           f"config reader reads a subset of YAML): "
                           f"{self.text.strip()!r}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1
        if self.peek() == "\t":
            raise self.error("a tab")

    def at_end(self) -> bool:
        """True at the end of the line or at a comment (`#` after a space
        or at the line's start)."""
        c = self.peek()
        return c == "" or (c == "#" and (self.pos == 0
                                         or self.text[self.pos - 1] == " "))

    def expect_end(self) -> None:
        self.skip_spaces()
        if not self.at_end():
            raise self.error(f"unexpected {self.text[self.pos:]!r}")

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out = []
        while True:
            c = self.peek()
            if c == "":
                raise self.error("a quoted string that does not close on "
                                 "its line")
            self.pos += 1
            if c == quote:
                if quote == "'" and self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if c == "\\" and quote == '"':
                e = self.peek()
                self.pos += 1
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in "xuU":
                    n = {"x": 2, "u": 4, "U": 8}[e]
                    digits = self.text[self.pos:self.pos + n]
                    if not re.fullmatch(f"[0-9a-fA-F]{{{n}}}", digits):
                        raise self.error(f"a bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += n
                else:
                    raise self.error(f"an unsupported escape \\{e}")
            else:
                out.append(c)

    def plain(self, flow: bool) -> str:
        """A plain scalar up to the end of the line, a comment, or (in a
        flow sequence) `,` / `]`; its value is resolved by the caller."""
        start = self.pos
        c = self.peek()
        if c in _NOT_PLAIN or (c in "-?:" and self.text[self.pos + 1:
                                                        self.pos + 2]
                               in ("", " ")):
            raise self.error(f"a value starting with {c!r}")
        while not self.at_end():
            c = self.peek()
            if c == "\t":
                raise self.error("a tab")
            if flow and c in ",[]{}":
                break
            if c == ":" and self.text[self.pos + 1:self.pos + 2] in (
                    ("", " ", ",") if flow else ("", " ")):
                raise self.error("a mapping inside a value")
            self.pos += 1
        text = self.text[start:self.pos].rstrip(" ")
        if _TIMESTAMP.match(text) or text in ("=", "<<"):
            raise self.error(f"the YAML 1.1 special value {text!r}")
        return text

    def flow_sequence(self) -> list:
        self.pos += 1            # '['
        items: list = []
        while True:
            self.skip_spaces()
            c = self.peek()
            if c == "]":
                self.pos += 1
                return items
            if c == "" or self.at_end():
                raise self.error("a flow sequence that does not close on "
                                 "its line")
            items.append(self.value(flow=True))
            self.skip_spaces()
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "]":
                raise self.error(f"unexpected {self.text[self.pos:]!r} in a "
                                 "flow sequence")

    def value(self, flow: bool) -> Any:
        c = self.peek()
        if c in ("'", '"'):
            return self.quoted()
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            raise self.error("a flow mapping")
        return resolve_scalar(self.plain(flow))

    def key(self) -> Any:
        c = self.peek()
        if c in ("'", '"'):
            k = self.quoted()
        else:
            if c == "?" and self.text[self.pos + 1:self.pos + 2] in ("", " "):
                raise self.error("a complex key")
            if c == "-" and self.text[self.pos + 1:self.pos + 2] in ("", " "):
                raise self.error("a block sequence")
            if c in _NOT_PLAIN:
                raise self.error(f"a key starting with {c!r}")
            start = self.pos
            while True:
                c = self.peek()
                if c == "" or self.at_end():
                    raise self.error("a line that is not `key: value`")
                if c == "\t":
                    raise self.error("a tab")
                if c == ":" and self.text[self.pos + 1:self.pos + 2] in (
                        "", " "):
                    break
                self.pos += 1
            text = self.text[start:self.pos].rstrip(" ")
            if _TIMESTAMP.match(text) or text in ("=", "<<"):
                raise self.error(f"the YAML 1.1 special key {text!r}")
            k = resolve_scalar(text)
        self.skip_spaces()
        if self.peek() != ":":
            raise self.error("a key with no `:`")
        self.pos += 1
        if self.peek() not in ("", " "):
            raise self.error("a key with no space after `:`")
        return k


def load_yaml(text: str, path: str = "<string>") -> dict:
    """Read a config file's text (the subset in the module docstring) into
    nested dicts, as `yaml.safe_load(text) or {}` does."""
    root: dict = {}
    stack: list[tuple[int, dict]] = []   # (indent, mapping), outermost first
    pending = None                       # (indent, mapping, key): no value yet
    for number, raw in enumerate(text.splitlines(), 1):
        line = _Line(path, number, raw)
        indent = len(raw) - len(raw.lstrip(" "))
        line.pos = indent
        if line.peek() == "\t":
            raise line.error("a tab")
        if line.at_end():
            continue
        if indent == 0 and (raw.startswith(("---", "...", "%"))):
            raise line.error("a document marker or directive")
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                p_map[p_key] = {}
                stack.append((indent, p_map[p_key]))
            else:
                p_map[p_key] = None
        if not stack:
            stack.append((indent, root))
        while len(stack) > 1 and stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent:
            raise line.error("indentation that matches no enclosing mapping")
        mapping = stack[-1][1]
        key = line.key()
        line.skip_spaces()
        if line.at_end():
            pending = (indent, mapping, key)
            continue
        mapping[key] = line.value(flow=False)
        line.expect_end()
    if pending is not None:
        pending[1][pending[2]] = None
    return root


class Args:
    """Recursive attribute view over a config dict."""

    def __init__(self, d: dict):
        self._d = {}
        for k, v in d.items():
            self._d[k] = Args(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._d[name]
        except KeyError as e:
            raise AttributeError(
                f"config has no key {name!r}; available: "
                f"{sorted(map(str, self._d))}") from e

    def __getitem__(self, name: str) -> Any:
        return self._d[name]

    def __contains__(self, name: str) -> bool:
        return name in self._d

    def get(self, name: str, default: Any = None) -> Any:
        return self._d.get(name, default)

    def keys(self):
        return self._d.keys()

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Args) else v
                for k, v in self._d.items()}

    def __repr__(self) -> str:
        return f"Args({self.to_dict()!r})"


def merge_dicts(base: dict, child: dict) -> dict:
    """Recursive merge; child keys win (the parent_config chain: the child
    file overrides its parent, lib/arguments/__init__.py:49-58)."""
    out = copy.deepcopy(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def underlay_dicts(base: dict, under: dict) -> dict:
    """Recursive merge where BASE keys win; `under` only fills gaps: the
    reference's `merge_configs(dict1, dict2)` (lib/arguments/__init__.py
    :32-42), which gives the experiment config precedence in
    `parse(data_cfg, parse(exp_cfg))`."""
    out = copy.deepcopy(base)
    for k, v in under.items():
        if k not in out:
            out[k] = copy.deepcopy(v)
        elif isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = underlay_dicts(out[k], v)
    return out


def load_config_dict(path: str, _seen: tuple = ()) -> dict:
    """Read a config file, resolving its parent_config chain (child wins).

    A relative parent is looked up beside the file, then in each of its
    ancestor directories (repo-root-relative names such as
    "configs/base.yaml"), then in the current directory."""
    path = os.path.abspath(path)
    if path in _seen:
        raise ValueError(f"parent_config cycle: {[*_seen, path]}")
    with open(path) as f:
        d = load_yaml(f.read(), path)
    parent = d.pop("parent_config", None)
    if parent:
        if not os.path.isabs(parent):
            candidates = []
            cur = os.path.dirname(path)
            while True:
                candidates.append(os.path.join(cur, parent))
                nxt = os.path.dirname(cur)
                if nxt == cur:
                    break
                cur = nxt
            candidates.append(os.path.abspath(parent))
            for cand in candidates:
                if os.path.exists(cand):
                    parent = cand
                    break
            else:
                raise FileNotFoundError(
                    f"parent_config {parent!r} (from {path}) not found; "
                    f"tried {candidates[:3]}...")
        d = merge_dicts(load_config_dict(parent, (*_seen, path)), d)
    return d


def parse(path: str, base: Args | None = None) -> Args:
    """Read a config file into Args, optionally underneath an existing Args:
    `parse(data_cfg, parse(exp_cfg))` keeps every value the experiment
    config set, and the data config's chain fills the rest."""
    d = load_config_dict(path)
    if base is not None:
        d = underlay_dicts(base.to_dict(), d)
    return Args(d)


def default_experiment() -> Args:
    """Built-in hyperparameter defaults mirroring the reference's
    configs/base.yaml + configs/exp.yaml, for use without files (the
    reference's `default_experiment`, values included)."""
    return Args({
        "seed": 1,
        "model_dir": "output",
        "task_name": "default",
        "exp_name": "exp",
        "dynamic": False,
        "testing_iterations": 1000,
        "saving_iterations": [15000, 20000, 25000, 30000],
        "visual_interval": 1000,
        "model": {
            "voxel_size": 0.15,
            "bkgd_extent_factor": 3,
            "object_extent_factor": 4,
            "obj_pt_num": 10_000,
            "dimension": 2,
            "sh_degree": 3,
            "white_background": False,
        },
        "opt": {
            "iterations": 30_000,
            "position_lr_init": 0.00016,
            "position_lr_final": 0.0000016,
            "position_lr_delay_mult": 0.01,
            "position_lr_max_steps": 30_000,
            "feature_lr": 0.0025,
            "opacity_lr": 0.05,
            "scaling_lr": 0.005,
            "rotation_lr": 0.001,
            "sh_increase_interval": 1000,
            "densification_interval": 100,
            "opacity_reset_interval": 3000,
            "densify_from_iter": 500,
            "densify_until_iter": 15_000,
            "densify_scale_threshold": 0.0002,
            "densify_grad_threshold": 0.0002,
            "densify_weight_threshold": 0.0,
            "prune_size_threshold": 0.1,
            "thresh_opa_prune": 0.003,
            "lambda_cd": 0.01,
            "lambda_depth_l1": 0.1,
            "lambda_intensity_l1": 0.85,
            "lambda_intensity_l2": 0.0,
            "lambda_intensity_dssim": 0.15,
            "lambda_raydrop_bce": 0.01,
            "lambda_reg": 0.01,
            "use_rayhit": True,
            "use_normal_init": True,
            "use_voxel_init": True,
            "rebin_interval": 0,
        },
        "refine": {
            "use_refine": True,
            "use_spatial": True,
            "epochs": 400,
            "batch_size": 16,
            "lr": 0.001,
        },
    })
