"""Constants the port uses, copied from revisionllm_tpu/constants.py.

Sentinel token ids spliced into the token stream stand for "insert video
features here" (-200) and "insert memory features here" (-300); -100 marks
positions excluded from the LM loss.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
MEMORY_TOKEN_INDEX = -300

DEFAULT_IMAGE_TOKEN = "<video>"
DEFAULT_MEMORY_TOKEN = "<memory>"

# Question templates of the eval drivers.
QUESTIONS = {
    "mad_grounding": "During which frames can we see {}?",
    "ego_assertive": "During which frames {}?",
    "ego_question": "Find the start and end time of the Query from the Video.\nQuery: {}",
    "retrieval": "During which video can we see {}?",
}
