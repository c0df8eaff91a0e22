"""The plain reference the benchmark holds the program to: the same
semantics written straight in PyTorch and numpy, independent of the
program. It imports nothing of the program and takes nothing the program
made: it fits its own codec, searches its own cuts, keeps its own tables
and renders both eyes itself (the right eye from the right camera, not by
the shift merge). Every function takes a `dtype`: float32 is the
reference, bfloat16 the control that a sound comparison must fail."""
