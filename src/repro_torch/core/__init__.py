"""ALA itself (paper Alg 1-8), ported: numpy bookkeeping on the host,
the LM solve, GBT histograms, tree traversal and bank distances on the
device."""
