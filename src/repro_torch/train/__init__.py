"""The training path: AdamW with fp32 or int8 moments (``optimizer``), the
train step with gradient accumulation (``train_step``), atomic async
checkpoints in the reference's layout (``checkpoint``) and the leaf order
they share (``tree``).  The reference's ``elastic`` (a mesh rebuilt on a
host loss) and ``grad_compress`` (a cross-pod psum) are not ported: on one
card there is no mesh to rebuild and no pod to reduce across."""
