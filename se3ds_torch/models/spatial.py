"""Maps split by rows over a process group: the row exchange beneath
`layers` (the port of the JAX package's height-partitioned generator,
where GSPMD shards the pano height, NHWC axis 1, over the mesh's
'spatial' axis and inserts the halo exchanges;
se3ds_tpu/models/inference.py:688-697).

`ResNetGenerator.forward(cond, rows=Rows(group))` splits its conditions into
`Band`s and runs its own forward on them: rank r holds rows
[R*r // n, R*(r+1) // n) of a map of R rows (`Rows.band`), the whole
width, and every channel. Elementwise layers, and the `layers.epilogue`
after each convolution, run on the band tensors. A layer that reads
across a band edge (a convolution of kernel height > 1 or stride > 1, a
transposed convolution, the 2x2 max pool, the nearest upsample) asks its
input band for the window that its output band reads (`Band.strided`,
`Band.transposed`), runs its whole-image op on that window, and keeps
its rows of the result (`Window.keep`). The window's rows are fetched
from the ranks that hold them (`Rows.fetch`, point-to-point).

Which module decides what:

* `layers` decides every pad: a convolution's rows and columns of pad
  and whether its width wraps (`layers.conv_pads`), a transposed
  convolution's crop, the max pool's -inf row. It pads the width itself,
  which is whole on every rank.
* This module decides which rows a rank holds and which it reads. The
  window of an output band comes from the GLOBAL row count, the op's
  kernel height, stride and height pads, with fill rows outside the map
  and strides aligned to global row 0, so the band outputs are the
  whole-image arithmetic row for row.
* A band may hold no rows (deep stages of a small pano hold fewer rows
  than ranks): its rank fetches nothing, runs the op on one window of
  fill and keeps none of it, and every other rank still finds each row it
  reads.

The generator gathers its two heads' outputs whole on every rank.
BatchNorm runs on its running statistics (eval), so no statistic crosses
ranks. Convolutions run on other shapes than the whole image's, so
results may differ from it by float rounding (the JAX package allows
`pred_depth` 2e-3 and `pred_rgb` one level,
tests/test_inference.py:524-561).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class Band(NamedTuple):
  """This rank's rows of an NCHW map of `rows` rows split over `group`."""
  x: torch.Tensor
  rows: int
  group: 'Rows'

  @property
  def shape(self) -> torch.Size:
    """The whole map's shape."""
    return self.x.shape[:2] + (self.rows,) + self.x.shape[3:]

  @property
  def dtype(self) -> torch.dtype:
    return self.x.dtype

  @property
  def device(self) -> torch.device:
    return self.x.device

  def like(self, x: torch.Tensor) -> 'Band':
    """`x` as these rows of a map of as many rows (an elementwise op's)."""
    return Band(x, self.rows, self.group)

  def strided(self, k: int, s: int, top: int, bottom: int,
              fill: float = 0.0) -> 'Window':
    """The window of a window op of kernel height `k` and stride `s` over
    the map with `top` and `bottom` rows of `fill` added: output row o
    reads the padded map's rows [o*s, o*s + k)."""
    out_rows = (self.rows + top + bottom - k) // s + 1
    return self.group.window(
        self, out_rows, lambda o0, o1: (o0 * s - top, (o1 - 1) * s - top + k),
        lambda a: (a + top) // s, fill)

  def transposed(self, k: int, s: int, top: int, bottom: int) -> 'Window':
    """The window of a transposed op of kernel height `k` and stride `s`
    (input row i feeds rows [i*s, i*s + k) of its full output, of
    (rows - 1)*s + k rows) whose output is the full one with `top` and
    `bottom` rows of zeros added (negative: cropped)."""
    if k < s:
      raise ValueError(f'kernel height {k} below stride {s}')
    out_rows = (self.rows - 1) * s + k + top + bottom
    return self.group.window(
        self, out_rows,
        lambda o0, o1: ((o0 - top - k) // s + 1, (o1 - 1 - top) // s + 1),
        lambda a: a * s + top, 0.0)


class Window(NamedTuple):
  """The input rows `x` that a rank's output rows of a window op read;
  its rows of an output of `rows` rows are `kept` rows of the op's output
  on `x`, from row `start`."""
  x: torch.Tensor
  start: int
  kept: int
  rows: int
  group: 'Rows'

  def keep(self, y: torch.Tensor) -> Band:
    """This rank's rows of `y`, the op's output on the window."""
    return Band(y[:, :, self.start:self.start + self.kept], self.rows,
                self.group)


class Rows:
  """A process group over which maps are split by rows."""

  def __init__(self, group):
    self.group = group
    self.size = dist.get_world_size(group)
    self.rank = dist.get_rank(group)
    self.peers = dist.get_process_group_ranks(group)

  def band(self, rows: int, rank: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of `rank`'s rows (default: this rank's)."""
    rank = self.rank if rank is None else rank
    return rows * rank // self.size, rows * (rank + 1) // self.size

  def split(self, x: torch.Tensor) -> Band:
    """This rank's band of a whole NCHW map."""
    start, stop = self.band(x.shape[2])
    return Band(x[:, :, start:stop], x.shape[2], self)

  def fetch(self, band: Band,
            need: Callable[[int], Tuple[int, int]], fill: float
            ) -> torch.Tensor:
    """Rows [a, b) = need(self.rank) of the global map, `fill` outside
    [0, rows); each rank q is sent the rows of this band in need(q).
    Every rank of the group calls it with the same `need`."""
    x = band.x
    start, stop = self.band(band.rows)
    a, b = need(self.rank)
    out = x.new_full(x.shape[:2] + (b - a,) + x.shape[3:], fill)
    ops, received = [], []
    for q in range(self.size):
      q0, q1 = self.band(band.rows, q)
      lo, hi = max(a, q0), min(b, q1)
      if lo < hi and q == self.rank:
        out[:, :, lo - a:hi - a] = x[:, :, lo - start:hi - start]
      elif lo < hi:
        buf = x.new_empty(x.shape[:2] + (hi - lo,) + x.shape[3:])
        ops.append(dist.P2POp(dist.irecv, buf, self.peers[q], self.group))
        received.append((buf, lo - a))
      if q == self.rank:
        continue
      qa, qb = need(q)
      lo, hi = max(qa, start), min(qb, stop)
      if lo < hi:
        ops.append(dist.P2POp(
            dist.isend, x[:, :, lo - start:hi - start].contiguous(),
            self.peers[q], self.group))
    if ops:
      for request in dist.batch_isend_irecv(ops):
        request.wait()
    for buf, at in received:
      out[:, :, at:at + buf.shape[2]] = buf
    return out

  def gather(self, band: Band) -> torch.Tensor:
    """The whole map on every rank."""
    return self.fetch(band, lambda q: (0, band.rows), 0.0)

  def window(self, band: Band, out_rows: int,
             need: Callable[[int, int], Tuple[int, int]],
             origin: Callable[[int], int], fill: float) -> Window:
    """The input rows [a, b) = need(o0, o1) that this rank's rows
    [o0, o1) of an output of `out_rows` rows read, where an op's output
    on input rows from a starts at output row origin(a) (a depends on o0
    alone). A rank whose band is empty gets the window of output row 0,
    fill only, and keeps none of it."""
    def need_of(q):
      o0, o1 = self.band(out_rows, q)
      return need(o0, o1) if o1 > o0 else (0, 0)

    o0, o1 = self.band(out_rows)
    kept = o1 - o0
    x = self.fetch(band, need_of, fill)
    if not kept:
      o0, o1 = 0, 1
      a, b = need(o0, o1)
      x = x.new_full(x.shape[:2] + (b - a,) + x.shape[3:], fill)
    return Window(x, o0 - origin(need(o0, o1)[0]), kept, out_rows, self)
