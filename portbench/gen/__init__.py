"""The benchmark's own input generators, frozen copies of the program's.

They live here so that a later change to the program cannot change the
yardstick's data. Nothing here imports the program.
"""
