"""Hardware abstraction layer: primes, Source, NTT, normalization, DFT ops."""
