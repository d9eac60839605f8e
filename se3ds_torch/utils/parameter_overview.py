"""Parameter overview tables (port of `se3ds_tpu.utils.parameter_overview`
over a module's `named_parameters`, names joined with '/' as the Flax
paths are)."""

from __future__ import annotations

import logging
from typing import Optional

from torch import nn


def count_parameters(module: nn.Module) -> int:
  return sum(p.numel() for p in module.parameters())


def get_parameter_overview(module: nn.Module, include_stats: bool = True,
                           max_lines: Optional[int] = None) -> str:
  """ASCII table of name/shape/size[/mean/std], sorted by name, and the
  total count."""
  params = {name.replace('.', '/'): p.detach()
            for name, p in module.named_parameters()}
  names = sorted(params)
  values = [params[n] for n in names]

  class _Column:

    def __init__(self, name, vals):
      self.name = name
      self.values = vals
      self.width = max([len(v) for v in vals + [name]] or [len(name)])

  columns = [
      _Column('Name', names),
      _Column('Shape', [str(tuple(v.shape)) for v in values]),
      _Column('Size', [f'{v.numel():,}' for v in values]),
  ]
  if include_stats:
    columns.extend([
        _Column('Mean', [f'{float(v.float().mean()):.3}' if v.numel()
                         else '-' for v in values]),
        _Column('Std', [f'{float(v.float().std(unbiased=False)):.3}'
                        if v.numel() else '-' for v in values]),
    ])
  var_line = '|' + ''.join(f' {{: <{c.width}s}} |' for c in columns)
  sep_line = var_line.replace(' ', '-').replace('|', '+')
  lines = [sep_line.format(*[''] * len(columns)),
           var_line.format(*[c.name for c in columns]),
           sep_line.format(*[''] * len(columns))]
  for i in range(len(names)):
    if max_lines and len(lines) >= max_lines - 3:
      lines.append('[...]')
      break
    lines.append(var_line.format(*[c.values[i] for c in columns]))
  lines.append(sep_line.format(*[''] * len(columns)))
  lines.append('Total: {:,}'.format(count_parameters(module)))
  return '\n'.join(lines)


def log_parameter_overview(module: nn.Module, msg: Optional[str] = None):
  table = get_parameter_overview(module)
  lines = ([msg] if msg else []) + table.split('\n')
  log = logging.getLogger('se3ds_torch')
  for i in range(0, len(lines), 80):
    log.info('\n%s', '\n'.join(lines[i:i + 80]))
