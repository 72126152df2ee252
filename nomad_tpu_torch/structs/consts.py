"""Domain constants.

Mirrors the constant vocabulary of the reference control plane
(reference: nomad/structs/structs.go) so that states/statuses/trigger types are
wire-compatible with Nomad's API surface.
"""

# --- Job types (reference: nomad/structs/structs.go:3524 area) ---
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_CORE = "_core"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100
CORE_JOB_PRIORITY = JOB_MAX_PRIORITY * 2

# --- Node ---
NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

NODE_SCHED_ELIGIBLE = "eligible"
NODE_SCHED_INELIGIBLE = "ineligible"

# --- Allocation desired status ---
ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

# --- Allocation client status ---
ALLOC_CLIENT_PENDING = "pending"
ALLOC_CLIENT_RUNNING = "running"
ALLOC_CLIENT_COMPLETE = "complete"
ALLOC_CLIENT_FAILED = "failed"
ALLOC_CLIENT_LOST = "lost"

# Desired-status descriptions (reference generic_sched.go / reconcile.go)
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_RESCHEDULED = "alloc was rescheduled because it failed"
ALLOC_LOST = "alloc is lost since its node is down"
ALLOC_IN_PLACE = "alloc updating in-place"
ALLOC_NODE_TAINTED = "alloc not needed as node is tainted"

# --- Evaluation ---
EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_PERIODIC_JOB = "periodic-job"
EVAL_TRIGGER_NODE_DRAIN = "node-drain"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_ALLOC_STOP = "alloc-stop"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"
EVAL_TRIGGER_DEPLOYMENT_WATCHER = "deployment-watcher"
EVAL_TRIGGER_DEPLOYMENT_PROMOTION = "deployment-promotion"
EVAL_TRIGGER_FAILED_FOLLOW_UP = "failed-follow-up"
EVAL_TRIGGER_MAX_PLANS = "max-plan-attempts"
EVAL_TRIGGER_RETRY_FAILED_ALLOC = "alloc-failure"
EVAL_TRIGGER_QUEUED_ALLOCS = "queued-allocs"
EVAL_TRIGGER_PREEMPTION = "preemption"
EVAL_TRIGGER_SCALING = "scaling"

# --- Deployments ---
DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"

DEPLOYMENT_DESC_NEWER_JOB = "Cancelled due to newer version of job"
DEPLOYMENT_DESC_FAILED_ALLOCS = "Failed due to unhealthy allocations"
DEPLOYMENT_DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DEPLOYMENT_DESC_SUCCESSFUL = "Deployment completed successfully"
DEPLOYMENT_DESC_STOPPED_JOB = "Cancelled because job is stopped"
DEPLOYMENT_DESC_NEEDS_PROMOTION = "Deployment is running but requires manual promotion"
DEPLOYMENT_DESC_AUTO_PROMOTION = "Deployment is running pending automatic promotion"

# description attached to allocs stopped by a destructive update
ALLOC_UPDATING = "alloc is being updated due to job update"

# --- Constraint operands (reference: scheduler/feasible.go:671-706) ---
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SEMVER = "semver"
CONSTRAINT_SET_CONTAINS = "set_contains"
CONSTRAINT_SET_CONTAINS_ALL = "set_contains_all"
CONSTRAINT_SET_CONTAINS_ANY = "set_contains_any"
CONSTRAINT_ATTR_IS_SET = "is_set"
CONSTRAINT_ATTR_IS_NOT_SET = "is_not_set"

# --- Task states ---
TASK_STATE_PENDING = "pending"
TASK_STATE_RUNNING = "running"
TASK_STATE_DEAD = "dead"

TASK_STARTED = "Started"
TASK_TERMINATED = "Terminated"
TASK_KILLING = "Killing"
TASK_KILLED = "Killed"
TASK_RESTARTING = "Restarting"
TASK_NOT_RESTARTING = "Not Restarting"
TASK_RECEIVED = "Received"
TASK_FAILED_VALIDATION = "Failed Validation"
TASK_SETUP_FAILURE = "Setup Failure"
TASK_DRIVER_FAILURE = "Driver Failure"
TASK_LEADER_DEAD = "Leader Task Dead"

# --- Reschedule policy ---
RESCHEDULE_DELAY_CONSTANT = "constant"
RESCHEDULE_DELAY_EXPONENTIAL = "exponential"
RESCHEDULE_DELAY_FIBONACCI = "fibonacci"

# --- Restart policy ---
RESTART_POLICY_FAIL = "fail"
RESTART_POLICY_DELAY = "delay"

# --- Migrate / update defaults ---
DEFAULT_MIN_HEALTHY_TIME_S = 10.0
DEFAULT_HEALTHY_DEADLINE_S = 300.0
DEFAULT_PROGRESS_DEADLINE_S = 600.0

# Plan normalization
MAX_RETAINED_JOB_VERSIONS = 6

# Scheduler types that are built in
SCHEDULERS = (JOB_TYPE_SERVICE, JOB_TYPE_BATCH, JOB_TYPE_SYSTEM, JOB_TYPE_CORE)

DEFAULT_NAMESPACE = "default"
DEFAULT_REGION = "global"
