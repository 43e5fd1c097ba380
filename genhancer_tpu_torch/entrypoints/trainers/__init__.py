"""Reference trainer names for ``genhancer-train-torch --trainer``."""
