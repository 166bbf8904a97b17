"""The plain reference the benchmark's answers are checked against: plain
PyTorch and numpy, importing nothing of the program (`sim`, `threefry`,
`fabrics`)."""
