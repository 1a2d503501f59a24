"""Plain float64 references of what the timed paths compute, in torch
operations and numpy: the OAK kernel, the SVGP and SGPR bounds with their gradients,
Adam, the flows' fit and one k-means step. They import no module of the port
and take nothing it made: every input comes from the seed or from a file
both sides read."""
