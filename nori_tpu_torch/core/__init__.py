"""Math and utility core: transforms, vector math, RNG, discrete PDFs."""
