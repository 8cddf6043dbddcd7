"""Launch helpers: device meshes and the H100 roofline."""
