from . import camera, pose, quaternion
from .camera import CameraRig

__all__ = ["quaternion", "pose", "camera", "CameraRig"]
