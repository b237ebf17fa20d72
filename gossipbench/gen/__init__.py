"""The benchmark's own input generators (frozen NumPy copies)."""
