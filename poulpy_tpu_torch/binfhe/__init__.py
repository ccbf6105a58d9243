"""Gate bootstrapping (lookup tables, CGGI blind rotation, boolean gates),
circuit bootstrapping, BDD arithmetic on FheUint and blind retrieval."""
