"""The plain reference of the photon-mapping frame: plain PyTorch, no
kernels, no acceleration structure of the program's and nothing imported
from it. It reads the scene description the benchmark made and works out
every derived quantity (camera, disk frames, intersections, photon map)
itself."""
