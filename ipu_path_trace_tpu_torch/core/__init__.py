from .vecmath import Vec3
from .scene import Scene, Material, default_scene, grid_scene, make_scene
from .camera import pixel_to_ray, aa_noise
from .geometry import intersect_scene
from .materials import sample_diffuse, reflect, refract, roulette_weight
