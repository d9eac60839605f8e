"""Gin-style configuration (a copy of `se3ds_tpu.config`).

The reference's public config surface is gin files
(configs/{lowres,highres}/*.gin) binding `Class.param = value`. The gin
package is not a dependency of this framework, so this module implements
the subset those configs use:

* `Class.param = value` bindings (numbers, strings, booleans, lists,
  tuples, %macros)
* `@Name` / `@module.Name` configurable references
* comments, `import` statements (ignored), `Macro = value`

`configurable(name)` registers a class/function; `apply_config(name,
**overrides)` resolves bound parameters. `operative_config_str()` renders
the operative config for provenance (reference task_manager.py expects
`operative_config-<step>.gin` files; the reference never wrote them —
we do, fixing that gap). The port's trainer module registers its own
classes under the JAX package's names (`GAN`, `ResNetGenerator`, ...), so
the repo's gin files apply to it unchanged.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable] = {}
_BINDINGS: Dict[str, Dict[str, Any]] = {}
_MACROS: Dict[str, Any] = {}
_OPERATIVE: Dict[str, Dict[str, Any]] = {}


class ConfigurableReference:
  """A `@Name` value: resolves to the registered callable, with its own
  bound parameters applied at call time."""

  def __init__(self, name: str):
    self.name = name

  def __call__(self, *args, **kwargs):
    fn = resolve(self.name)
    merged = {**get_bindings(self.name), **kwargs}
    _OPERATIVE.setdefault(_short_name(self.name), {}).update(merged)
    return fn(*args, **merged)

  def __repr__(self):
    return f'@{self.name}'


def _short_name(name: str) -> str:
  return name.split('.')[-1]


def configurable(name_or_fn=None, denylist=()):
  """Registers a configurable (decorator), like @gin.configurable."""
  def wrap(fn, name=None):
    key = name or fn.__name__
    _REGISTRY[key] = fn
    fn._gin_denylist = tuple(denylist)
    return fn

  if callable(name_or_fn):
    return wrap(name_or_fn)
  return lambda fn: wrap(fn, name_or_fn)


def register(name: str, fn: Callable) -> None:
  _REGISTRY[name] = fn


def resolve(name: str) -> Callable:
  short = _short_name(name)
  if name in _REGISTRY:
    return _REGISTRY[name]
  if short in _REGISTRY:
    return _REGISTRY[short]
  raise KeyError(f'No configurable registered under {name!r}. '
                 f'Known: {sorted(_REGISTRY)}')


def clear_config() -> None:
  _BINDINGS.clear()
  _MACROS.clear()
  _OPERATIVE.clear()


def get_bindings(name: str) -> Dict[str, Any]:
  short = _short_name(name)
  out: Dict[str, Any] = {}
  for key in (name, short):
    if key in _BINDINGS:
      out.update(_BINDINGS[key])
  return out


def bind(target: str, param: str, value: Any) -> None:
  _BINDINGS.setdefault(_short_name(target), {})[param] = value


_IDENT_RE = re.compile(r'^\w+$')


def _parse_value(text: str) -> Any:
  text = text.strip()
  if text.startswith('@'):
    ref = text[1:].strip()
    if ref.endswith('()'):
      # gin's evaluated references (`@Name()` calls the configurable at
      # binding time). None of the reference configs use them; rejecting
      # loudly beats silently registering a reference named 'Name()'.
      raise ValueError(
          f'Evaluated gin references (@{ref}) are not supported; bind '
          f'@{ref[:-2]} and call it where it is consumed.')
    if '/' in ref:
      raise ValueError(
          f'Scoped gin references (@{ref}) are not supported; this '
          'config system has a single global scope.')
    return ConfigurableReference(ref)
  if text.startswith('%'):
    macro = text[1:].strip()
    if macro not in _MACROS:
      raise KeyError(
          f'Undefined macro %{macro} (macros must be defined before '
          f'use; known: {sorted(_MACROS)})')
    return _MACROS[macro]
  lowered = text.lower()
  if lowered == 'true':
    return True
  if lowered == 'false':
    return False
  if lowered == 'none':
    return None
  try:
    return ast.literal_eval(text)
  except (ValueError, SyntaxError):
    # gin requires strings to be quoted; accept a bare identifier as a
    # string for convenience but reject anything structured — a value
    # like `[1, 2,]x` silently becoming a string hides config typos.
    if _IDENT_RE.match(text):
      return text
    raise ValueError(
        f'Cannot parse gin value {text!r} (strings must be quoted; '
        'lists/tuples must be valid Python literals).') from None


def _strip_comment(line: str) -> str:
  """Removes a trailing `# comment`, ignoring `#` inside quotes."""
  quote = None
  for i, ch in enumerate(line):
    if quote:
      if ch == quote:
        quote = None
    elif ch in ('"', "'"):
      quote = ch
    elif ch == '#':
      return line[:i]
  return line


_LINE_RE = re.compile(r'^(?P<target>[\w./]+)\s*=\s*(?P<value>.+)$')


def parse_config(config_str: str) -> None:
  """Parses gin-format text into the binding store.

  Supports the constructs the reference configs use (see module
  docstring) plus multiline lists/tuples and quoted `#`; gin features
  with no counterpart here — scopes (`a/b.c`), evaluated references
  (`@f()`), `include` — are rejected with a loud error rather than
  silently misread.
  """
  pending = ''
  for raw_line in config_str.splitlines():
    line = _strip_comment(raw_line).rstrip()
    if not line.strip():
      continue
    if pending:
      line = pending + ' ' + line.strip()
      pending = ''
    # Continuation: unbalanced brackets.
    if (line.count('(') > line.count(')')
        or line.count('[') > line.count(']')):
      pending = line
      continue
    stripped = line.strip()
    if stripped.startswith(('import ', 'from ')):
      continue  # gin imports register python modules; our registry is static
    if stripped.startswith('include'):
      raise ValueError(
          f'gin `include` is not supported ({stripped!r}); pass every '
          'config file explicitly to parse_config_files_and_bindings.')
    m = _LINE_RE.match(stripped)
    if not m:
      raise ValueError(f'Cannot parse gin line: {raw_line!r}')
    target = m.group('target')
    if '/' in target:
      raise ValueError(
          f'gin scopes are not supported ({target!r}); this config '
          'system has a single global scope — drop the scope prefix.')
    value = _parse_value(m.group('value'))
    if '.' not in target:
      _MACROS[target] = value
    else:
      cls, param = target.rsplit('.', 1)
      bind(cls, param, value)
  if pending:
    raise ValueError(f'Unterminated binding: {pending!r}')


def parse_config_files_and_bindings(config_files=None, bindings=None) -> None:
  """absl-style entry (reference main.py:47)."""
  for path in config_files or []:
    with open(path) as f:
      parse_config(f.read())
  for b in bindings or []:
    parse_config(b)


def apply_config(name: str, /, *args, **kwargs):
  """Instantiates a configurable with bindings applied (explicit kwargs
  win over bindings; denylisted params must come from kwargs)."""
  fn = resolve(name)
  bound = dict(get_bindings(name))
  for key in getattr(fn, '_gin_denylist', ()):
    bound.pop(key, None)
  merged = {**bound, **kwargs}
  _OPERATIVE.setdefault(_short_name(name), {}).update(merged)
  return fn(*args, **merged)


def operative_config_str() -> str:
  """Renders the bindings actually consumed, gin-style."""
  lines = []
  for target in sorted(set(list(_OPERATIVE) + list(_BINDINGS))):
    params = {**_BINDINGS.get(target, {}),
              **_OPERATIVE.get(target, {})}
    for param in sorted(params):
      value = params[param]
      if isinstance(value, ConfigurableReference):
        rendered = f'@{value.name}'
      elif isinstance(value, str):
        rendered = repr(value)
      else:
        rendered = repr(value)
      lines.append(f'{target}.{param} = {rendered}')
  return '\n'.join(lines) + '\n'


def write_operative_config(model_dir: str, step: int) -> str:
  """Writes operative_config-<step>.gin (consumed by the task manager for
  CSV provenance, reference task_manager.py:189-201)."""
  path = os.path.join(model_dir, f'operative_config-{step}.gin')
  with open(path, 'w') as f:
    f.write(operative_config_str())
  return path
