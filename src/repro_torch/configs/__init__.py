"""Model configurations: a copy of the reference package's plain
dataclasses (``base``, ``registry`` and one file per architecture), with
only the import paths changed."""
