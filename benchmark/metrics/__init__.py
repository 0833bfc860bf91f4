"""Per-layer metric readers, one file a metric (``<metric>.py``), each with
``read(record)``: the number, or None where the record holds nothing to
read. ``record`` is what a window driver gathered (spans, epoch rows,
the profile, the FLOP count, the card)."""
