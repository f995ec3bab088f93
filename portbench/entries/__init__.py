"""The program's entries a cell's window drives, one module each: a class
`Entry` that sets up, runs one unit of work (a batch, an episode), profiles
one more, releases the program's state and judges what the window
produced against the plain reference."""
