# A frozen copy of serl_tpu_torch/envs/physics/panda_model.py at commit 89bf89d,
# its CUDA binding left out: the benchmark's plain reference of the env.
"""Panda + Robotiq 2F-85 + cube model constants (GENERATED — do not edit).

The port's own copy of `serl_tpu/envs/physics/panda_model.py`, which
tools/extract_model.py generated from the reference MJCF (standard
MuJoCo-menagerie Franka Panda / Robotiq 2F-85 spec). Kept identical to it
(tests/test_torch_imports.py checks); the port never imports serl_tpu.
Pure data consumed by the batched physics in serl_tpu_torch/envs/physics/ and
packed into the constant buffer of the CUDA control-step kernel.

Conventions: 7 moving arm links (link1..link7); per-link local transform
(BODY_POS/BODY_QUAT, parent frame), COM (BODY_IPOS, link frame), 3x3 inertia
about COM (BODY_INERTIA, link frame). The rigid gripper assembly is composed
into link7. All joints are revolute about local +z.
"""

import numpy as np

NUM_LINKS = 7
PANDA_HOME = np.array([ 0.          , -0.785       ,  0.          , -2.35        ,  0.          ,
  1.57        ,  0.7853981634])

# link0 is the fixed base; BODY_* below are for link0..link7 (8 rows), where
# row i is the local transform of link_i in its parent frame.
BODY_POS = np.array([[ 0.    ,  0.    ,  0.    ],
 [ 0.    ,  0.    ,  0.333 ],
 [ 0.    ,  0.    ,  0.    ],
 [ 0.    , -0.316 ,  0.    ],
 [ 0.0825,  0.    ,  0.    ],
 [-0.0825,  0.384 ,  0.    ],
 [ 0.    ,  0.    ,  0.    ],
 [ 0.088 ,  0.    ,  0.    ]])
BODY_QUAT = np.array([[ 1.          ,  0.          ,  0.          ,  0.          ],
 [ 1.          ,  0.          ,  0.          ,  0.          ],
 [ 0.7071067812, -0.7071067812,  0.          ,  0.          ],
 [ 0.7071067812,  0.7071067812,  0.          ,  0.          ],
 [ 0.7071067812,  0.7071067812,  0.          ,  0.          ],
 [ 0.7071067812, -0.7071067812,  0.          ,  0.          ],
 [ 0.7071067812,  0.7071067812,  0.          ,  0.          ],
 [ 0.7071067812,  0.7071067812,  0.          ,  0.          ]])
BODY_MASS = np.array([0.629769    , 4.970684    , 0.646926    , 3.228604    , 3.587895    , 1.225946    ,
 1.666555    , 1.7881303388])
BODY_IPOS = np.array([[-0.041018    , -0.00014     ,  0.049974    ],
 [ 0.003875    ,  0.002081    , -0.04762     ],
 [-0.003141    , -0.02872     ,  0.003495    ],
 [ 0.027518    ,  0.039252    , -0.066502    ],
 [-0.05317     ,  0.104419    ,  0.027454    ],
 [-0.011953    ,  0.041065    , -0.038437    ],
 [ 0.060149    , -0.014117    , -0.010517    ],
 [ 0.004291253 , -0.0017736381,  0.1116786869]])
BODY_INERTIA = np.array([[[ 3.1500000000e-03,  8.2903980986e-07,  1.5000000000e-04],
  [ 8.2903980986e-07,  3.8799999999e-03,  8.2298985391e-06],
  [ 1.5000000000e-04,  8.2298985391e-06,  4.2850000001e-03]],

 [[ 7.0337000000e-01, -1.3900445959e-04,  6.7719998775e-03],
  [-1.3900445959e-04,  7.0660997488e-01,  1.9169456977e-02],
  [ 6.7719998775e-03,  1.9169456977e-02,  9.1170251179e-03]],

 [[ 7.9619995406e-03, -3.9249998357e-03,  1.0253999663e-02],
  [-3.9249998357e-03,  2.8110000068e-02,  7.0399983626e-04],
  [ 1.0253999663e-02,  7.0399983626e-04,  2.5995000392e-02]],

 [[ 3.7242000002e-02, -4.7610000020e-03, -1.1395999998e-02],
  [-4.7610000020e-03,  3.6155000000e-02, -1.2804999999e-02],
  [-1.1395999998e-02, -1.2804999999e-02,  1.0829999998e-02]],

 [[ 2.5853002311e-02,  7.7959981252e-03, -1.3319997508e-03],
  [ 7.7959981252e-03,  1.9551999300e-02,  8.6410017050e-03],
  [-1.3319997508e-03,  8.6410017050e-03,  2.8322998389e-02]],

 [[ 3.5548999995e-02, -2.1170000093e-03, -4.0370000177e-03],
  [-2.1170000093e-03,  2.9473999999e-02,  2.2899993697e-04],
  [-4.0370000177e-03,  2.2899993697e-04,  8.6270000058e-03]],

 [[ 1.9639999731e-03,  1.0900001059e-04, -1.1579999582e-03],
  [ 1.0900001059e-04,  4.3539999985e-03,  3.4099999937e-04],
  [-1.1579999582e-03,  3.4099999937e-04,  5.4330000284e-03]],

 [[ 1.6742768657e-02, -5.8201353002e-04, -8.0856189953e-04],
  [-5.8201353002e-04,  1.4294526779e-02, -8.9750966213e-04],
  [-8.0856189953e-04, -8.9750966213e-04,  5.4511053074e-03]]])  # (8, 3, 3)

JOINT_ARMATURE = np.array([0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1])
JOINT_DAMPING = np.array([1., 1., 1., 1., 1., 1., 1.])
JOINT_RANGE = np.array([[-2.8973,  2.8973],
 [-1.7628,  1.7628],
 [-2.8973,  2.8973],
 [-3.0718, -0.0698],
 [-2.8973,  2.8973],
 [-0.0175,  3.7525],
 [-2.8973,  2.8973]])
TORQUE_LIMIT = np.array([[-87.,  87.],
 [-87.,  87.],
 [-87.,  87.],
 [-87.,  87.],
 [-12.,  12.],
 [-12.,  12.],
 [-12.,  12.]])

PINCH_POS_L7 = np.array([ 9.7969051078e-18, -9.7969051078e-18,  2.5580000000e-01])
PINCH_QUAT_L7 = np.array([ 9.2387953919e-01,  4.2564840291e-19,  9.3924366551e-20, -3.8268341623e-01])
ATTACH_SITE_POS_L7 = np.array([ 2.0933740406e-18, -2.0933740406e-18,  1.0700000000e-01])
ATTACH_SITE_QUAT_L7 = np.array([ 9.2387953919e-01,  1.0171022558e-19, -9.6237292204e-20, -3.8268341623e-01])
ATTACH_BODY_POS_L7 = np.array([0.   , 0.   , 0.107])
ATTACH_BODY_QUAT_L7 = np.array([0.3826834162, 0.          , 0.          , 0.9238795392])

TCP_HOME = np.array([3.0779602468e-01, 6.0642514638e-20, 4.4421535729e-01])
TCP_HOME_QUAT = np.array([-4.3649739422e-11,  9.9999687500e-01, -1.7459859281e-08,  2.4999973958e-03])
MOCAP_HOME_QUAT = np.array([0., 1., 0., 0.])

GRAVITY = np.array([0.0, 0.0, -9.81])

# --- gripper (reduced 1-DoF model) ---
# driver angle theta in [0, 0.8]; right pad center in pinch frame:
#   y(theta) = polyval(PAD_Y_POLY, theta)   (left pad mirrored, y -> -y)
#   z(theta) = polyval(PAD_Z_POLY, theta)
#   x ~ -0.0000000000 (constant)
PAD_Y_POLY = np.array([ 0.0090701946, -0.0192545751, -0.0438821001,  0.0466962041])
PAD_Z_POLY = np.array([-0.0027977178, -0.0237793662,  0.0373102924, -0.0143407953])
PAD_X = -0.0000000000
PAD_HALF = np.array([0.011   , 0.004   , 0.009375])   # pad box half-size (x, y, z) in pad frame
PAD_FRICTION = np.array([7.e-01, 5.e-03, 1.e-04])
DRIVER_RANGE = np.array([0.0, 0.8])
# fingers_actuator (general, tendon "split"): force = gain*ctrl + bias
#   gainprm=[0.3137255, 0.       , 0.       ], biasprm=[   0., -100.,  -10.], forcerange=[-5.,  5.]
GRIPPER_GAIN = 0.3137255000
GRIPPER_BIAS_KP = 100.0000000000
GRIPPER_BIAS_KV = 10.0000000000
GRIPPER_FORCERANGE = np.array([-5.,  5.])

# --- block / arena ---
BLOCK_HALF = np.array([0.02, 0.02, 0.02])
BLOCK_MASS = 0.1000000000
BLOCK_FRICTION = np.array([1.e+00, 5.e-03, 1.e-04])
FLOOR_FRICTION = np.array([1.e+00, 5.e-03, 1.e-04])

# --- cameras ---
FRONT_CAM_POS = np.array([1.3, 0. , 0.7])
FRONT_CAM_QUAT = np.array([0.5963678059, 0.3799282038, 0.3799282038, 0.5963678059])
FRONT_CAM_FOVY = 45.0
WRIST_CAM_POS_ATT = np.array([-0.05 ,  0.015,  0.   ])
WRIST_CAM_QUAT_ATT = np.array([ 0.          ,  0.7071067812, -0.7071067812,  0.          ])
WRIST_CAM_FOVY = 42.5
