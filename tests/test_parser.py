"""Scene parser golden tests against the reference's own scene files
(reference: scenes/*.txt, parser semantics src/scene.cpp:47-337)."""

import numpy as np
import pytest

from pathtracer.scene.parser import (
    CUBE,
    DIELECTRIC,
    LAMBERTIAN,
    LIGHT,
    MICROFACET,
    OBJ,
    SPHERE,
    build_transformation_matrix,
    load_scene,
)
from pathtracer.scene.camera import derive_camera


class TestCornell:
    @pytest.fixture(scope="class")
    def scene(self, scenes_dir):
        return load_scene(scenes_dir / "cornell.txt")

    def test_materials(self, scene):
        assert len(scene.materials) == 9
        m0 = scene.materials[scene.material_names["0"]]
        assert m0.type == LIGHT
        np.testing.assert_allclose(m0.albedo, [2, 2, 2])
        spe = scene.materials[scene.material_names["spe"]]
        assert spe.type == MICROFACET
        # roughness 0 clamps to ROUGHNESS_MIN at load (src/scene.cpp:295)
        assert spe.roughness == pytest.approx(1e-3)
        glass = scene.materials[scene.material_names["whiteglass"]]
        assert glass.type == DIELECTRIC and glass.ior == pytest.approx(1.6)
        assert scene.materials[scene.material_names["2"]].type == LAMBERTIAN

    def test_geoms(self, scene):
        assert len(scene.geoms) == 8
        assert scene.geoms[0].type == CUBE
        assert scene.geoms[6].type == SPHERE
        assert scene.geoms[6].material_id == scene.material_names["spe"]
        np.testing.assert_allclose(scene.geoms[3].translation, [0, 10, 0])
        np.testing.assert_allclose(scene.geoms[3].scale, [3, 0.3, 3])
        # light cube has the Light material
        assert scene.materials[scene.geoms[3].material_id].type == LIGHT

    def test_camera_block(self, scene):
        assert scene.camera.resolution == (800, 800)
        assert scene.camera.fovy == 45
        assert scene.iterations == 5000
        assert scene.trace_depth == 8
        assert scene.image_name == "cornell"
        np.testing.assert_allclose(scene.camera.position, [0, 5, 3])
        np.testing.assert_allclose(scene.camera.look_at, [0, 5, 0])

    def test_derived_camera(self, scene):
        cam = derive_camera(scene.camera)
        # view = (0,0,-1) after the theta/phi round-trip (src/main.cpp:106-121)
        np.testing.assert_allclose(cam.view, [0, 0, -1], atol=1e-6)
        np.testing.assert_allclose(cam.right, [1, 0, 0], atol=1e-6)
        np.testing.assert_allclose(cam.up, [0, 1, 0], atol=1e-6)
        # pixelLength with tan(FULL fovy) quirk (src/scene.cpp:218-227)
        assert cam.pixel_length[1] == pytest.approx(2 * np.tan(np.radians(45)) / 800)


class TestTransforms:
    def test_identity(self):
        m = build_transformation_matrix([0, 0, 0], [0, 0, 0], [1, 1, 1])
        np.testing.assert_allclose(m, np.eye(4), atol=1e-7)

    def test_trs_order(self):
        # glm: T * Rx * Ry * Rz * S applied to column vectors
        m = build_transformation_matrix([1, 2, 3], [0, 90, 0], [2, 2, 2])
        p = m @ np.array([1, 0, 0, 1.0])
        # scale→(2,0,0), rotY90→(0,0,-2), translate→(1,2,1)
        np.testing.assert_allclose(p[:3], [1, 2, 1], atol=1e-5)

    def test_rotation_composition(self):
        m = build_transformation_matrix([0, 0, 0], [90, 90, 0], [1, 1, 1])
        p = m @ np.array([0, 0, 1, 1.0])
        # Rz then Ry then Rx on (0,0,1): Ry90→(1,0,0); Rx90→(1,0,0)
        np.testing.assert_allclose(p[:3], [1, 0, 0], atol=1e-5)


class TestOtherScenes:
    def test_mis_test(self, scenes_dir):
        scene = load_scene(scenes_dir / "mis_test.txt")
        assert len(scene.materials) == 8
        assert len(scene.geoms) == 8
        lights = [m for m in scene.materials if m.type == LIGHT]
        assert len(lights) == 5
        # the RIOR typo line is tolerated and leaves the default ior
        assert scene.materials[scene.material_names["3"]].ior == pytest.approx(1.5)
        assert scene.camera.resolution == (1080, 1080)

    def test_obj_scene(self, scenes_dir):
        scene = load_scene(scenes_dir / "texturecube.txt")
        objs = [g for g in scene.geoms if g.type == OBJ]
        assert len(objs) == 1
        mesh = scene.meshes[objs[0].mesh_key]
        assert mesh["positions"].shape[0] == 12  # cube = 12 triangles
        assert mesh["has_uvs"] and mesh["has_normals"]
        assert len(scene.textures) == 1
        tex_mat = scene.materials[scene.material_names["tex"]]
        assert tex_mat.albedo_tex >= 0
        assert scene.materials[scene.material_names["white"]].albedo_tex == -1

    def test_env_scene(self, scenes_dir):
        scene = load_scene(scenes_dir / "envbunny.txt")
        assert scene.env_map_id >= 0
        env = scene.textures[scene.env_map_id]
        assert env.ndim == 3 and env.shape[2] == 3
        assert env.max() > 1.0  # HDR content

    def test_material_by_name_and_id(self, scenes_dir):
        scene = load_scene(scenes_dir / "cornell.txt")
        # object 6 references material by name "spe", object 0 by id "1"
        assert scene.geoms[0].material_id == scene.material_names["1"]
        assert scene.geoms[6].material_id == scene.material_names["spe"]


class TestMissingAssets:
    """A scene token that names a mesh or image file that does not exist
    is an error; numeric constants still parse."""

    SCENE = """
MATERIAL m
TYPE        Lambertian
ALBEDO      {albedo}
METALLIC    0
ROUGHNESS   0.5
IOR         0

CAMERA
RES         8 8
FOVY        45
ITERATIONS  1
DEPTH       2
FILE        t
EYE         0 0 5
LOOKAT      0 0 0
UP          0 1 0

OBJECT o
{shape}
material m
TRANS       0 0 0
ROTAT       0 0 0
SCALE       1 1 1
"""

    @pytest.mark.parametrize(
        "albedo,shape",
        [
            (".5 .5 .5", "missing/mesh.obj"),
            ("missing/tex.png", "sphere"),
            ("missing/tex.jpg", "sphere"),
        ],
    )
    def test_missing_asset_raises(self, tmp_path, albedo, shape):
        path = tmp_path / "s.txt"
        path.write_text(self.SCENE.format(albedo=albedo, shape=shape))
        with pytest.raises(FileNotFoundError, match="missing/"):
            load_scene(path)

    def test_constants_still_parse(self, tmp_path):
        path = tmp_path / "s.txt"
        path.write_text(self.SCENE.format(albedo=".25 .5 .75", shape="sphere"))
        scene = load_scene(path)
        np.testing.assert_allclose(scene.materials[0].albedo, [0.25, 0.5, 0.75])
        assert scene.materials[0].roughness == pytest.approx(0.5)
        assert scene.materials[0].albedo_tex == -1


class TestObjFastPath:
    """The vectorized OBJ fast path must agree with the general loop."""

    def _write(self, tmp_path, name, body):
        p = tmp_path / name
        p.write_text(body)
        return p

    def test_vtn_triangles_fast_equals_slow(self, tmp_path):
        import numpy as np
        from pathtracer.scene import obj_loader as ol

        rng = np.random.default_rng(3)
        v = rng.normal(size=(9, 3))
        n = rng.normal(size=(9, 3))
        t = rng.random((9, 2))
        lines = [f"v {a} {b} {c}" for a, b, c in v]
        lines += [f"vn {a} {b} {c}" for a, b, c in n]
        lines += [f"vt {a} {b}" for a, b in t]
        lines += [f"f {i+1}/{i+1}/{i+1} {i+2}/{i+2}/{i+2} {i+3}/{i+3}/{i+3}"
                  for i in (0, 3, 6)]
        p = self._write(tmp_path, "vtn.obj", "\n".join(lines) + "\n")
        fast = ol.load_obj(p)
        vls = [l[2:] for l in lines if l.startswith("v ")]
        vnls = [l[3:] for l in lines if l.startswith("vn ")]
        vtls = [l[3:] for l in lines if l.startswith("vt ")]
        fls = [l[2:] for l in lines if l.startswith("f ")]
        slow = ol._load_obj_slow(vls, vnls, vtls, fls)
        for k in ("positions", "normals", "uvs"):
            np.testing.assert_allclose(fast[k], slow[k], rtol=1e-6)

    def test_ngon_falls_back_to_fan(self, tmp_path):
        import numpy as np
        from pathtracer.scene import obj_loader as ol

        body = (
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "f 1 2 3 4\n"  # quad -> 2 fan triangles (reference: scene.cpp:385-389)
        )
        m = ol.load_obj(self._write(tmp_path, "quad.obj", body))
        assert m["positions"].shape == (2, 3, 3)
        np.testing.assert_allclose(m["positions"][0, 0], [0, 0, 0])
        np.testing.assert_allclose(m["positions"][1, 0], [0, 0, 0])  # fan pivot

    def test_double_slash_normals(self, tmp_path):
        import numpy as np
        from pathtracer.scene import obj_loader as ol

        body = (
            "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
            "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
            "f 1//1 2//2 3//3\n"
        )
        m = ol.load_obj(self._write(tmp_path, "vn.obj", body))
        assert m["has_normals"]
        np.testing.assert_allclose(m["normals"][0], [[0, 0, 1]] * 3)

    def test_negative_indices(self, tmp_path):
        import numpy as np
        from pathtracer.scene import obj_loader as ol

        body = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
        m = ol.load_obj(self._write(tmp_path, "neg.obj", body))
        np.testing.assert_allclose(
            m["positions"][0], [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
        )
