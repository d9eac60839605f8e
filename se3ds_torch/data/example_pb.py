"""Protocol-buffer wire encoding (the varint and length-delimited writers
of `se3ds_tpu.data.example_pb`, copied): what the event-file logger needs
to write Event and Summary messages without protobuf."""

from __future__ import annotations


def write_varint(out: bytearray, value: int) -> None:
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return


def encode_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
  """Appends field `field` (wire type 2) holding `payload`."""
  write_varint(out, (field << 3) | 2)
  write_varint(out, len(payload))
  out.extend(payload)
