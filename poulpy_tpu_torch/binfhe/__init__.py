"""Gate bootstrapping: lookup tables, CGGI blind rotation and boolean gates."""
