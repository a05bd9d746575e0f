"""One driver a kind of traffic, found by the ``driver`` key of a mix's file."""
