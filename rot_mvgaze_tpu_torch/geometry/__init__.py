from rot_mvgaze_tpu_torch.geometry.gaze import (
    angular_error,
    angular_error_numpy,
    pitchyaw_to_vector,
    pitchyaw_to_vector_numpy,
    rotation_matrix_2d,
    vector_to_pitchyaw,
    vector_to_pitchyaw_numpy,
)

__all__ = [
    "angular_error",
    "angular_error_numpy",
    "pitchyaw_to_vector",
    "pitchyaw_to_vector_numpy",
    "rotation_matrix_2d",
    "vector_to_pitchyaw",
    "vector_to_pitchyaw_numpy",
]
