"""PyTorch/CUDA port of the Whack-a-Mole reproduction.

The package mirrors `repro`'s module layout (`core`, `kernels`, `net`,
`configs`, `models`, `train`, `launch`) so each module's counterpart is
easy to find.  It imports torch and numpy only.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""
