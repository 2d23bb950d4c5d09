"""The plain reference that decides ``correct``: NumPy and plain PyTorch,
written from the paper's definitions. Nothing here imports the program.
"""
