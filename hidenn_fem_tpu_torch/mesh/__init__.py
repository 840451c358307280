"""mesh layer of the PyTorch port."""

from .types import TriMesh
from .structured import generate_mesh, rectangle_tri_zigzag, proxy_plate_mesh
from .gmsh_backend import generate_mesh_gmsh, have_gmsh
from .delaunay import generate_mesh_delaunay, generate_mesh_unstructured
from .hybrid import generate_mesh_hybrid, hybrid_mesh_from_arrays
from .coloring import color_nodes, check_coloring
