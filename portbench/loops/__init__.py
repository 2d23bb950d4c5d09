"""The loops that drive the program, one file each, named by a traffic
mix's ``loop``: ``prepare``, ``warmup``, ``window`` and ``judge``."""
