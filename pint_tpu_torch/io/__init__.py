"""Host IO of the port: par files, tim files, clock files, FITS tables."""
