"""Command-line tools: the multi-controller launcher, its monitor and
report, and host-side analyses whose results the documentation quotes."""
