"""Mesh normals and shading models (PyTorch port of dirt_tpu/lighting.py).

API parity with the reference ``dirt/lighting.py``.  The segment sum of
``vertex_normals`` is ``index_add_``; the scatter of
``vertex_normals_pre_split`` is ``index_copy``.  Every function takes
batched ``[*, V, 3]`` inputs and a ``device`` keyword: tensor arguments
keep their device, arguments that are all Python or numpy values go to
``device``, and without one to the CUDA card (devices.py).

Where JAX and PyTorch differentiate a tie differently, this module
follows JAX, so that both packages give the same gradients on the same
scene: |x| is ``where(x >= 0, x, -x)`` (gradient 1 at 0, as ``jnp.abs``;
``torch.abs`` gives 0) and max(x, 0) is ``torch.maximum`` (0.5 at a tie,
as ``jnp.maximum``; ``clamp_min`` gives 1).  One tie stays apart: the
norm of a zero vector (a zero-area face's normal) has a NaN gradient in
JAX and 0 here.
"""

import torch

from .devices import as_f32, input_device


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _positive(x):
    return torch.maximum(x, torch.zeros_like(x))


def _prepare_vertices_and_faces(vertices, faces, device):
    device = input_device((vertices, faces), device)
    return (as_f32(vertices, device),
            torch.as_tensor(faces, dtype=torch.int32, device=device))


def _get_face_normals(vertices, faces):
    # vertices: [*, V, 3]; faces: [F, 3].  Returns unit normals [*, F, 3].
    # Reference: dirt/lighting.py:24-31 (face normals are normalised
    # before averaging, so the average is NOT area-weighted).
    vertices_by_face = vertices[..., faces.long(), :]   # [*, F, 3, 3]
    normals_by_face = torch.linalg.cross(
        vertices_by_face[..., 1, :] - vertices_by_face[..., 0, :],
        vertices_by_face[..., 2, :] - vertices_by_face[..., 0, :], dim=-1)
    return normals_by_face / (
        torch.linalg.norm(normals_by_face, dim=-1, keepdim=True) + 1.e-12)


def vertex_normals(vertices, faces, device=None):
    """Computes vertex normals for the given meshes.

    For each vertex, returns the renormalised average of the unit normals of
    all faces that include that vertex.

    Args:
        vertices: [*, V, 3] or [*, V, 4] (w is dropped).
        faces: int [F, 3].

    Returns:
        [*, V, 3].

    Reference: dirt/lighting.py:34-93.
    """
    vertices, faces = _prepare_vertices_and_faces(vertices, faces, device)
    vertices = vertices[..., :3]
    normals_by_face = _get_face_normals(vertices, faces)       # [*, F, 3]
    # Each face contributes its unit normal to its three corners.
    corner_normals = torch.repeat_interleave(normals_by_face, 3, dim=-2)
    summed = torch.zeros_like(vertices).index_add(
        -2, faces.reshape(-1).long(), corner_normals)
    return summed / (torch.linalg.norm(summed, dim=-1, keepdim=True)
                     + 1.e-12)


def vertex_normals_pre_split(vertices, faces, static=False, device=None):
    """Computes vertex normals for pre-split meshes.

    Identical to ``vertex_normals`` but assumes each vertex is used by exactly
    one face (e.g. after ``split_vertices_by_face``): each vertex simply takes
    its face's unit normal.  Vertices referenced by no face get zeros.

    Reference: dirt/lighting.py:101-133.  ``static`` is accepted for API
    parity and has no effect.
    """
    del static
    vertices, faces = _prepare_vertices_and_faces(vertices, faces, device)
    vertices = vertices[..., :3]
    normals_by_face = _get_face_normals(vertices, faces)
    corner_normals = torch.repeat_interleave(normals_by_face, 3, dim=-2)
    return torch.zeros_like(vertices).index_copy(
        -2, faces.reshape(-1).long(), corner_normals)


def split_vertices_by_face(vertices, faces, device=None):
    """An equivalent mesh where each vertex is used by exactly one face.

    Args:
        vertices: [*, V, 3] or [*, V, 4].
        faces: int [F, 3].

    Returns:
        (new_vertices [*, F*3, C], new_faces int32 [F, 3]).

    Reference: dirt/lighting.py:136-179.
    """
    vertices, faces = _prepare_vertices_and_faces(vertices, faces, device)
    new_vertices = vertices[..., faces.reshape(-1).long(), :]
    new_faces = torch.arange(faces.shape[0] * 3, dtype=torch.int32,
                             device=faces.device).reshape(-1, 3)
    return new_vertices, new_faces


def diffuse_directional(vertex_normals, vertex_colors, light_direction,
                        light_color, double_sided=True, device=None):
    """Lambertian reflectance under a single directional light.

    Args:
        vertex_normals: [*, V, 3], assumed normalised.
        vertex_colors: [*, V, C] albedo.
        light_direction: [*, 3], assumed normalised (direction the light
            travels).
        light_color: [*, C].
        double_sided: if true, back faces are shaded like front faces.

    Returns:
        [*, V, C] reflectance.

    Reference: dirt/lighting.py:182-225.
    """
    device = input_device((vertex_normals, vertex_colors, light_direction,
                           light_color), device)
    vertex_normals, vertex_colors, light_direction, light_color = (
        as_f32(x, device) for x in (vertex_normals, vertex_colors,
                                    light_direction, light_color))
    cosines = vertex_normals @ -light_direction[..., None]     # [*, V, 1]
    cosines = _abs(cosines) if double_sided else _positive(cosines)
    return light_color[..., None, :] * vertex_colors * cosines


def specular_directional(vertex_positions, vertex_normals,
                         vertex_reflectivities, light_direction, light_color,
                         camera_position, shininess, double_sided=True,
                         device=None):
    """Phong specular reflectance under a single directional light.

    Args:
        vertex_positions: [*, V, 3].
        vertex_normals: [*, V, 3], assumed normalised.
        vertex_reflectivities: [*, V, C].
        light_direction: [*, 3], assumed normalised.
        light_color: [*, C].
        camera_position: [*, 3].
        shininess: [*] specular exponent.
        double_sided: if true, back faces are shaded like front faces.

    Returns:
        [*, V, C] reflectance.

    Reference: dirt/lighting.py:228-288 (including its exact stabiliser
    placement: 1e-12 is added to the *normalised* view direction).
    """
    inputs = (vertex_positions, vertex_normals, vertex_reflectivities,
              light_direction, light_color, camera_position, shininess)
    device = input_device(inputs, device)
    (vertex_positions, vertex_normals, vertex_reflectivities,
     light_direction, light_color, camera_position, shininess) = (
        as_f32(x, device) for x in inputs)

    vertices_to_light_direction = -light_direction
    reflected_directions = (
        -vertices_to_light_direction[..., None, :]
        + 2. * (vertex_normals @ vertices_to_light_direction[..., None])
        * vertex_normals)                                      # [*, V, 3]
    vertex_to_camera = camera_position[..., None, :] - vertex_positions
    cosines = torch.sum(
        (vertex_to_camera
         / torch.linalg.norm(vertex_to_camera, dim=-1, keepdim=True)
         + 1.e-12) * reflected_directions, dim=-1, keepdim=True)
    cosines = _abs(cosines) if double_sided else _positive(cosines)
    return (light_color[..., None, :] * vertex_reflectivities
            * torch.pow(cosines, shininess[..., None, None]))


def diffuse_point(vertex_positions, vertex_normals, vertex_colors,
                  light_position, light_color, double_sided=True,
                  device=None):
    """Lambertian reflectance under a single point light.

    Args:
        vertex_positions: [*, V, 3].
        vertex_normals: [*, V, 3], assumed normalised.
        vertex_colors: [*, V, C].
        light_position: [*, 3].
        light_color: [*, C].
        double_sided: if true, back faces are shaded like front faces.

    Returns:
        [*, V, C] reflectance.

    Reference: dirt/lighting.py:291-343.
    """
    inputs = (vertex_positions, vertex_normals, vertex_colors,
              light_position, light_color)
    device = input_device(inputs, device)
    (vertex_positions, vertex_normals, vertex_colors, light_position,
     light_color) = (as_f32(x, device) for x in inputs)

    relative_positions = vertex_positions - light_position[..., None, :]
    incident_directions = relative_positions / (
        torch.linalg.norm(relative_positions, dim=-1, keepdim=True) + 1.e-12)
    cosines = torch.sum(vertex_normals * incident_directions, dim=-1)
    cosines = _abs(cosines) if double_sided else _positive(cosines)
    return light_color[..., None, :] * vertex_colors * cosines[..., None]
