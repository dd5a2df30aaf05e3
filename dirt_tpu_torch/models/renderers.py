"""Renderer pipelines as torch modules (PyTorch port of
dirt_tpu/models/renderers.py).

Each renderer is an ``nn.Module`` configured by the JAX dataclass's fields
and defaults (image size, camera, lights, backend); ``render`` (also
``forward``, so ``model(...)`` works) is differentiable with respect to
every tensor argument.  Geometry enters as object-space vertices plus
faces; the pipeline applies object->world->camera->clip transforms,
computes normals, shades (per-vertex or deferred per-pixel) and
rasterises.  The modules hold no parameters: the scene is the caller's.

Tensor arguments keep their device; when none is a tensor, the inputs go
to ``device``, and without one to the CUDA card (devices.py).
"""

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .. import lighting, matrices, rasterise_ops
from ..devices import as_f32, input_device
from ..utils import textures as texture_utils


def _homogenise(vertices, device):
    vertices = as_f32(vertices, device)
    if vertices.shape[-1] == 3:
        vertices = torch.cat([vertices, torch.ones_like(vertices[..., :1])],
                             dim=-1)
    return vertices


def _faces(faces, device):
    return torch.as_tensor(faces, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Perspective camera with the reference's conventions."""
    translation: Sequence[float] = (0., -1.5, -3.5)
    rotation: Sequence[float] = (-0.3, 0., 0.)
    near: float = 0.1
    far: float = 20.
    right: float = 0.1

    def matrices(self, width, height, device=None):
        """(view, projection) [4, 4] on `device` (default: the card)."""
        device = input_device((), device)
        view = matrices.compose(
            matrices.translation(self.translation, device=device),
            matrices.rodrigues(self.rotation, device=device))
        projection = matrices.perspective_projection(
            near=self.near, far=self.far, right=self.right,
            aspect=float(height) / width, device=device)
        return view, projection


class _Renderer(nn.Module):
    """A dataclass of fields that is also an nn.Module (no parameters)."""

    def __post_init__(self):
        nn.Module.__init__(self)

    def forward(self, *args, **kwargs):
        return self.render(*args, **kwargs)


@dataclasses.dataclass(eq=False)
class GouraudRenderer(_Renderer):
    """Direct per-vertex diffuse lighting (samples/simple.py pipeline)."""
    width: int
    height: int
    camera: Camera = Camera()
    light_direction: Sequence[float] = (1., 0., 0.)
    light_color: Sequence[float] = (1., 1., 1.)
    ambient: float = 0.2
    backend: Optional[str] = None

    def render(self, vertices_obj, faces, albedo, object_rotation,
               background=None, device=None):
        """Renders [H, W, C]; differentiable wrt all tensor arguments."""
        return rasterise_ops.rasterise(
            *self.scene(vertices_obj, faces, albedo, object_rotation,
                        background, device), backend=self.backend)

    def scene(self, vertices_obj, faces, albedo, object_rotation,
              background=None, device=None):
        """What `render` rasterises: (background [H, W, C], clip-space
        vertices [V, 4], lit vertex colours [V, C], faces [F, 3])."""
        device = input_device((vertices_obj, faces, albedo, object_rotation,
                               background), device)
        vertices = _homogenise(vertices_obj, device)
        faces = _faces(faces, device)
        albedo = as_f32(albedo, device)
        world = vertices @ matrices.rodrigues(object_rotation, device=device)
        normals = lighting.vertex_normals_pre_split(world, faces)
        view, projection = self.camera.matrices(self.width, self.height,
                                                device)
        clip = world @ view @ projection

        lit = lighting.diffuse_directional(
            normals, albedo, self.light_direction, self.light_color) \
            * (1. - self.ambient) + albedo * self.ambient
        if background is None:
            background = torch.zeros(self.height, self.width,
                                     albedo.shape[-1], device=device)
        return as_f32(background, device), clip, lit, faces


@dataclasses.dataclass(eq=False)
class DeferredPhongRenderer(_Renderer):
    """Deferred per-pixel ambient+diffuse+specular (samples/deferred.py)."""
    width: int
    height: int
    camera: Camera = Camera()
    diffuse_color: Sequence[float] = (1., 0., 0.)
    specular_color: Sequence[float] = (1., 1., 1.)
    background_color: Sequence[float] = (0., 0., 0.3)
    shininess: float = 6.
    ambient: float = 0.2
    backend: Optional[str] = None

    def render(self, vertices_obj, faces, albedo, object_rotation,
               light_direction, device=None):
        device = input_device((vertices_obj, faces, albedo, object_rotation,
                               light_direction), device)
        vertices = _homogenise(vertices_obj, device)
        faces = _faces(faces, device)
        albedo = as_f32(albedo, device)
        light_direction = as_f32(light_direction, device)
        world = vertices @ matrices.rodrigues(object_rotation, device=device)
        normals = lighting.vertex_normals_pre_split(world, faces)
        view, projection = self.camera.matrices(self.width, self.height,
                                                device)
        clip = world @ view @ projection

        height, width = self.height, self.width

        def shader_fn(gbuffer, view_matrix, light_dir):
            mask = gbuffer[:, :, :1]
            positions = gbuffer[:, :, 1:4]
            base = gbuffer[:, :, 4:7]
            nrm = gbuffer[:, :, 7:]
            ambient = base * self.ambient
            diffuse = lighting.diffuse_directional(
                nrm.reshape(-1, 3), base.reshape(-1, 3), light_dir,
                self.diffuse_color, double_sided=False,
            ).reshape(height, width, 3)
            camera_position = torch.linalg.inv(view_matrix)[3, :3]
            specular = lighting.specular_directional(
                positions.reshape(-1, 3), nrm.reshape(-1, 3),
                base.reshape(-1, 3), light_dir, self.specular_color,
                camera_position=camera_position,
                shininess=self.shininess, double_sided=False,
            ).reshape(height, width, 3)
            shaded = (diffuse + specular + ambient) * mask
            background = as_f32(self.background_color, gbuffer.device)
            out = shaded + background * (1. - mask)
            # clip to [0, 1] as max-then-min (jnp.clip's tie gradients)
            return torch.minimum(torch.maximum(out, torch.zeros_like(out)),
                                 torch.ones_like(out))

        attributes = torch.cat([torch.ones_like(world[:, :1]), world[:, :3],
                                albedo, normals], dim=1)
        return rasterise_ops.rasterise_deferred(
            torch.zeros(height, width, 10, device=device), clip, attributes,
            faces, shader_fn=shader_fn,
            shader_additional_inputs=[view, light_direction],
            backend=self.backend)


@dataclasses.dataclass(eq=False)
class TexturedRenderer(_Renderer):
    """Deferred UV-mapped texturing, diffuse light (samples/textured.py)."""
    width: int
    height: int
    camera: Camera = Camera()
    light_color: Sequence[float] = (0.6, 0.6, 0.6)
    background_color: Sequence[float] = (0., 0., 0.3)
    ambient: float = 0.4
    normals_fn: Callable = lighting.vertex_normals
    backend: Optional[str] = None

    def render(self, vertices_obj, faces, uvs, texture, object_rotation,
               light_direction, device=None):
        device = input_device((vertices_obj, faces, uvs, texture,
                               object_rotation, light_direction), device)
        vertices = _homogenise(vertices_obj, device)
        faces = _faces(faces, device)
        texture = as_f32(texture, device)
        light_direction = as_f32(light_direction, device)
        world = vertices @ matrices.rodrigues(object_rotation, device=device)
        normals = self.normals_fn(world[:, :3], faces)
        view, projection = self.camera.matrices(self.width, self.height,
                                                device)
        clip = world @ view @ projection

        height, width = self.height, self.width

        def shader_fn(gbuffer, tex, light_dir):
            mask = gbuffer[:, :, :1]
            uv = gbuffer[:, :, 1:3]
            nrm = gbuffer[:, :, 3:]
            base = texture_utils.sample_texture(
                tex, texture_utils.uvs_to_pixel_indices(uv, tex.shape[:2]))
            diffuse = lighting.diffuse_directional(
                nrm.reshape(-1, 3), base.reshape(-1, 3), light_dir,
                self.light_color, double_sided=True,
            ).reshape(height, width, 3)
            shaded = (diffuse + base * self.ambient) * mask
            background = as_f32(self.background_color, gbuffer.device)
            return shaded + background * (1. - mask)

        attributes = torch.cat([torch.ones_like(world[:, :1]),
                                as_f32(uvs, device), normals], dim=1)
        return rasterise_ops.rasterise_deferred(
            torch.zeros(height, width, 6, device=device), clip, attributes,
            faces, shader_fn=shader_fn,
            shader_additional_inputs=[texture, light_direction],
            backend=self.backend)
